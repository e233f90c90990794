"""Recorders the metric readers share: what a wrapped program call left
that a reader needs, kept while the traced window runs.

The scan's operands and outputs are padded to bucket sizes (the pods to
`Pb`, the groups to `Gb`, the claims to `Cb`: ops/fused.py:399-406); the
least bytes and operations of a scan count only the real ones. Which
operand and output carries which padded axis is a frozen copy of the
scan's layout (karpenter_tpu_torch/convert.py:75-89 `SCAN_OPERANDS`,
ops/fused.py:408-475, ops/packer.py:934-935 `_scan_finals`).
"""

from __future__ import annotations

# operand index -> {axis: "P" | "G" | "C"}; an axis counts as padded only
# where its size is the bucket's (a dummy operand has size 1 there)
OPERAND_AXES = {
    0: {0: "P"},  # pod_gi
    1: {0: "C"},  # claim_pad
    2: {0: "G"}, 3: {0: "G"},  # g_req, g_floor
    6: {1: "G"}, 7: {1: "G"}, 8: {1: "G"}, 9: {1: "G"},  # tol, open_ok, open_fam, open_uok
    10: {1: "G"}, 11: {1: "G"},  # trans_kind, trans_fam
    15: {1: "G"},  # node_ok
    19: {1: "G"},  # open_cand
}
# output index -> the same: pod_claim, pod_node, pod_seq; claim_ti, claim_fam, u_valid
OUTPUT_AXES = {2: {0: "P"}, 3: {0: "P"}, 4: {0: "P"}, 5: {0: "C"}, 6: {0: "C"}, 7: {0: "C"}}


def real_bytes(shapes, axes: dict, pad: dict, real: dict) -> int:
    """Bytes of tensors given as (shape, element size) (None: no tensor),
    with each padded axis at its real size."""
    total = 0
    for i, item in enumerate(shapes):
        if item is None:
            continue
        shape, n = item
        for ax, size in enumerate(shape):
            kind = axes.get(i, {}).get(ax)
            n *= real[kind] if kind is not None and size == pad[kind] else size
        total += n
    return total


def _shapes(tensors) -> list:
    import torch

    return [(tuple(t.shape), t.element_size()) if isinstance(t, torch.Tensor) else None for t in tensors]


def scan_call(args, kwargs, result) -> dict:
    """`packer.solve_scan(cfg, operands)`: the shapes of its operands and
    outputs, and as 0-d device tensors (no sync inside the window) its
    pods, nodes, groups (the largest group index of a pod, plus one),
    claims and steps, read by `resolve` after the window."""
    ops = args[1]
    return {"operands": _shapes(ops), "outputs": _shapes(result), "n_pods": ops[13], "n_nodes": ops[14],
            "groups": ops[0].max() + 1, "nclaims": result[1], "steps": result[-1]}


def resolve(call: dict) -> dict:
    """A kept scan call -> its real sizes G (groups), U, D, N (nodes), the
    kernel's steps and the bytes of its operands read once and its outputs
    written once, at the real sizes."""
    opnd = call["operands"]
    pad = {"P": opnd[0][0][0], "G": opnd[2][0][0], "C": opnd[1][0][0]}
    real = {"P": int(call["n_pods"]), "G": int(call["groups"]), "C": int(call["nclaims"])}
    nbytes = real_bytes(opnd, OPERAND_AXES, pad, real) + real_bytes(call["outputs"], OUTPUT_AXES, pad, real)
    return {"G": real["G"], "D": opnd[2][0][1], "U": opnd[4][0][0], "N": int(call["n_nodes"]),
            "steps": int(call["steps"]), "bytes": nbytes}


def scan_steps(args, kwargs, result) -> int:
    """A full or resumed scan launch's steps (its last output)."""
    return int(result[-1])
