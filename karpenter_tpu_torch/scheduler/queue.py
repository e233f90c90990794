"""Pod scheduling queue: CPU-then-memory descending (first-fit-decreasing
order), with last-length loop detection.

Mirrors the reference's scheduling/queue.go:29-108.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod


class Queue:
    def __init__(self, pods: list[Pod], pod_data: dict):
        def sort_key(p: Pod):
            requests = pod_data[p.metadata.uid].requests
            return (
                -requests.get(wk.RESOURCE_CPU, 0.0),
                -requests.get(wk.RESOURCE_MEMORY, 0.0),
                p.metadata.creation_timestamp,
                p.metadata.uid,
            )

        self._pods = sorted(pods, key=sort_key)
        self._head = 0  # index head instead of re-slicing: O(1) pop
        # UID -> queue length at last push; popping at the same length means
        # no progress since the pod was re-queued -> stop (queue.go:41-53).
        self._last_len: dict[str, int] = {}

    def pop(self) -> Optional[Pod]:
        if self._head >= len(self._pods):
            return None
        pod = self._pods[self._head]
        if self._last_len.get(pod.metadata.uid) == len(self):
            return None
        self._head += 1
        return pod

    def push(self, pod: Pod) -> None:
        self._pods.append(pod)
        self._last_len[pod.metadata.uid] = len(self)

    def __len__(self) -> int:
        return len(self._pods) - self._head
