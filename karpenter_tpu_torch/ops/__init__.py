"""Device kernels and drivers: the CUDA execution backend for the
provisioning solve.

Label keys and values are interned into a global bit-space; every distinct
`Requirement` becomes one row of arrays; the hot
`filterInstanceTypesByRequirements` sweep (reference
pkg/controllers/provisioning/scheduling/nodeclaim.go:373-441) becomes

    compat[P, I] = all-over-pod-requirements ReqCompat[R, I]

computed by packed-bit kernels on the card (ops/feasibility.py).
"""
