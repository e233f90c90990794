"""The lean kernel launch (karpenter_tpu_torch/device.py `launch`), on the CPU.

`launch` calls a kernel's C entry point with the operands' card current
and that card's current raw stream appended. On the card it reads both
through torch's own CUDA accessors; here those accessors are replaced by a
fake of two cards, each with its own current stream, so the switching a
mesh shard on another card needs (and a one-card machine never shows) is
held on every branch: no switch when the card is current, a switch and a
switch back when it is not, the switch back after a failing entry point
too, and the stream read anew every call.
"""

from __future__ import annotations

import pytest
import torch

from karpenter_tpu_torch import device


class FakeCards:
    """torch._C's device and stream accessors over two fake cards."""

    def __init__(self):
        self.current = 0
        self.streams = {0: 1000, 1: 2000}
        self.exchanges = []

    def get_device(self):
        return self.current

    def exchange(self, idx):
        self.exchanges.append(idx)
        prev, self.current = self.current, idx
        return prev

    def maybe_exchange(self, idx):
        self.exchanges.append(idx)
        prev, self.current = self.current, idx
        return prev

    def raw_stream(self, idx):
        return self.streams[idx]


@pytest.fixture
def cards(monkeypatch):
    fake = FakeCards()
    monkeypatch.setattr(torch._C, "_cuda_getDevice", fake.get_device, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_exchangeDevice", fake.exchange, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_maybeExchangeDevice", fake.maybe_exchange, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", fake.raw_stream, raising=False)
    return fake


def test_launch_on_the_current_card_switches_nothing(cards):
    seen = []

    def entry(*args):
        seen.append((cards.current, args))
        return 0

    assert device.launch(torch.device("cuda", 0), entry, 7, None, 9) == 0
    assert seen == [(0, (7, None, 9, 1000))]
    assert cards.exchanges == [] and cards.current == 0


def test_launch_on_another_card_switches_there_and_back(cards):
    seen = []

    def entry(*args):
        seen.append((cards.current, args))
        return 3

    assert device.launch(torch.device("cuda", 1), entry, 5) == 3
    assert seen == [(1, (5, 2000))]  # on card 1, with card 1's stream
    assert cards.exchanges == [1, 0] and cards.current == 0


def test_launch_switches_back_when_the_entry_point_raises(cards):
    def entry(*args):
        raise RuntimeError("the entry point failed")

    with pytest.raises(RuntimeError):
        device.launch(torch.device("cuda", 1), entry)
    assert cards.current == 0 and cards.exchanges == [1, 0]


def test_launch_reads_the_stream_anew_each_call(cards):
    """A stream context changes the current stream between calls: nothing
    is cached."""
    seen = []

    def entry(*args):
        seen.append(args[-1])
        return 0

    dev = torch.device("cuda", 0)
    device.launch(dev, entry)
    cards.streams[0] = 1234  # as `with torch.cuda.stream(s):` would make it
    device.launch(dev, entry)
    assert seen == [1000, 1234]
