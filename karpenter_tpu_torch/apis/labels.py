"""Well-known labels, annotations, taints and normalization tables.

Mirrors the semantics of the reference's pkg/apis/v1/labels.go:32-183 and
pkg/apis/v1/taints.go (constants only — the representation is our own).
"""

from __future__ import annotations

GROUP = "karpenter.sh"
COMPATIBILITY_GROUP = "compatibility." + GROUP

# Well known values (reference labels.go:32-38)
ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# Kubernetes upstream label keys we depend on
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"

# Karpenter-specific domains and labels (reference labels.go:41-47)
NODEPOOL_LABEL_KEY = GROUP + "/nodepool"
NODE_INITIALIZED_LABEL_KEY = GROUP + "/initialized"
NODE_REGISTERED_LABEL_KEY = GROUP + "/registered"
NODE_DO_NOT_SYNC_TAINTS_LABEL_KEY = GROUP + "/do-not-sync-taints"
CAPACITY_TYPE_LABEL_KEY = GROUP + "/capacity-type"

# Karpenter-specific annotations (reference labels.go:50-57)
DO_NOT_DISRUPT_ANNOTATION_KEY = GROUP + "/do-not-disrupt"
PROVIDER_COMPATIBILITY_ANNOTATION_KEY = COMPATIBILITY_GROUP + "/provider"
NODEPOOL_HASH_ANNOTATION_KEY = GROUP + "/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = GROUP + "/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = GROUP + "/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY = GROUP + "/nodeclaim-min-values-relaxed"

# Finalizers (reference labels.go:60-62)
TERMINATION_FINALIZER = GROUP + "/termination"

# Taint keys (reference pkg/apis/v1/taints.go)
DISRUPTED_TAINT_KEY = GROUP + "/disrupted"
UNREGISTERED_TAINT_KEY = GROUP + "/unregistered"

# Upstream taint keys recognised as ephemeral during node startup
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_EXTERNAL_CLOUD_PROVIDER = "node.cloudprovider.kubernetes.io/uninitialized"

# Well-known resource names
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

WELL_KNOWN_RESOURCES = frozenset(
    {RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE, RESOURCE_PODS}
)

# Restricted domains: prohibited by kubelet or reserved (reference labels.go:66-70)
RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

# Sub-domains of restricted domains that are allowed (reference labels.go:74-78)
LABEL_DOMAIN_EXCEPTIONS = frozenset(
    {"kops.k8s.io", "node.kubernetes.io", "node-restriction.kubernetes.io"}
)

# Restricted-domain labels Karpenter understands and allows (reference labels.go:83-92)
# Uniquely identifies a capacity reservation on a reserved offering. The
# reference leaves this provider-overridable and its in-tree providers
# register it as well-known (cloudprovider/types.go:44-49,
# fake/cloudprovider.go:45) — without that, no claim could ever be
# compatible with a reserved offering's requirements.
RESERVATION_ID_LABEL_KEY = GROUP + "/reservation-id"

WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL_KEY,
        LABEL_TOPOLOGY_ZONE,
        LABEL_TOPOLOGY_REGION,
        LABEL_INSTANCE_TYPE,
        LABEL_ARCH,
        LABEL_OS,
        CAPACITY_TYPE_LABEL_KEY,
        LABEL_WINDOWS_BUILD,
        RESERVATION_ID_LABEL_KEY,
    }
)

WELL_KNOWN_VALUES_FOR_REQUIREMENTS = {
    CAPACITY_TYPE_LABEL_KEY: frozenset(
        {CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT, CAPACITY_TYPE_RESERVED}
    )
}

# Labels that must never be injected onto nodes (reference labels.go:116-118)
RESTRICTED_LABELS = frozenset({LABEL_HOSTNAME})

# Aliased/legacy label keys normalized into well-known ones (reference labels.go:122-129)
NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": LABEL_TOPOLOGY_ZONE,
    "failure-domain.beta.kubernetes.io/region": LABEL_TOPOLOGY_REGION,
    "beta.kubernetes.io/arch": LABEL_ARCH,
    "beta.kubernetes.io/os": LABEL_OS,
    "beta.kubernetes.io/instance-type": LABEL_INSTANCE_TYPE,
}


def get_label_domain(key: str) -> str:
    if "/" in key:
        return key.split("/", 1)[0]
    return ""


def is_restricted_node_label(key: str) -> bool:
    """True if a node label should not be injected by the provisioner.

    Mirrors reference labels.go:156-172.
    """
    if key in WELL_KNOWN_LABELS:
        return True
    domain = get_label_domain(key)
    for exception in LABEL_DOMAIN_EXCEPTIONS:
        if domain == exception or domain.endswith("." + exception):
            return False
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain == restricted or domain.endswith("." + restricted):
            return True
    return key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> str | None:
    """Returns an error string if the label is restricted (labels.go:132-140)."""
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return (
            f"label {key} is restricted; specify a well known label "
            f"or a custom label that does not use a restricted domain"
        )
    return None
