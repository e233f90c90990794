"""HostPort conflict tracking per simulated node.

Mirrors the reference's pkg/scheduling/hostportusage.go:35-120: each
<hostIP, port, protocol> on a node must be unique; 0.0.0.0/:: wildcard IPs
conflict with everything on the same port+protocol.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.apis.core import Pod

_UNSPECIFIED = ("0.0.0.0", "::")


@dataclass(frozen=True)
class HostPort:
    ip: str
    port: int
    protocol: str

    def matches(self, other: "HostPort") -> bool:
        if self.protocol != other.protocol or self.port != other.port:
            return False
        if self.ip != other.ip and self.ip not in _UNSPECIFIED and other.ip not in _UNSPECIFIED:
            return False
        return True


def get_host_ports(pod: Pod) -> list[HostPort]:
    """Extract host ports; empty hostIP defaults to 0.0.0.0
    (hostportusage.go:95-120)."""
    out = []
    for c in list(pod.spec.containers) + list(pod.spec.init_containers):
        for p in c.ports:
            if p.host_port == 0:
                continue
            out.append(
                HostPort(ip=p.host_ip or "0.0.0.0", port=p.host_port, protocol=p.protocol)
            )
    return out


class HostPortUsage:
    def __init__(self):
        self._reserved: dict[tuple[str, str], list[HostPort]] = {}

    def __bool__(self) -> bool:
        return bool(self._reserved)

    def copy(self) -> "HostPortUsage":
        """Independent copy for simulations; HostPort entries are frozen."""
        out = HostPortUsage()
        out._reserved = {k: list(v) for k, v in self._reserved.items()}
        return out

    def add(self, pod: Pod, ports: list[HostPort]) -> None:
        self._reserved[(pod.metadata.namespace, pod.metadata.name)] = ports

    def conflicts(self, pod: Pod, ports: list[HostPort]) -> Optional[str]:
        key = (pod.metadata.namespace, pod.metadata.name)
        for new in ports:
            for pod_key, entries in self._reserved.items():
                if pod_key == key:
                    continue
                for existing in entries:
                    if new.matches(existing):
                        return (
                            f"hostPort conflict: {new.ip}:{new.port}/{new.protocol} "
                            f"vs existing {existing.ip}:{existing.port}/{existing.protocol}"
                        )
        return None

    def delete_pod(self, namespace: str, name: str) -> None:
        self._reserved.pop((namespace, name), None)
