"""A run with the timed path broken underneath: the harness skips its look
for a card, drives the rest of a run on the CPU, and ``correct`` comes out
false for each fault the cells can have."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import make_root

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell="tinycoi.known"):
    return harness.run(cell, SEED, 0.05, False, time.perf_counter(), root=root,
                       device="cpu", log=lambda m: None)


def test_unbroken_run_is_correct(root):
    assert run(root)["correct"] is True


@pytest.mark.parametrize("cell", ["tinycoi.known", "tinyssu.v4"])
def test_fold_that_leaves_its_state_unchanged(root, cell, monkeypatch):
    """The fold returns its planes as they started (all zero)."""
    import raxtax_tpu_torch.engine.device as device

    orig = device.fold_planes
    monkeypatch.setattr(device, "fold_planes",
                        lambda *a, **k: torch.zeros_like(orig(*a, **k)))
    r = run(root, cell)
    assert r["correct"] is False and r["check"]["lines_differ"]["value"] > 0


def test_half_of_each_batch_left_out(root, monkeypatch):
    from raxtax_tpu_torch.engine.device import DeviceClassifier

    orig = DeviceClassifier.submit_batch
    monkeypatch.setattr(DeviceClassifier, "submit_batch",
                        lambda self, chunk: orig(self, chunk[: len(chunk) // 2 or 1]))
    r = run(root)
    assert r["correct"] is False
    assert r["failed"] > 0 and r["check"]["unanswered"]["value"] == r["failed"]


def test_answer_altered_where_it_is_produced(root, monkeypatch):
    """The evaluation's text of every answer changes in its last digit."""
    from raxtax_tpu_torch.engine.device import DeviceClassifier

    orig = DeviceClassifier.finalize_batch

    def altered(self, state):
        results = orig(self, state)
        for r in results:
            text = r.out_string()
            r.out_text = text[:-1] + ("1" if text[-1] != "1" else "2")
        return results

    monkeypatch.setattr(DeviceClassifier, "finalize_batch", altered)
    r = run(root)
    assert r["correct"] is False and r["check"]["lines_differ"]["value"] > 0


def test_counts_altered_in_the_fold(root, monkeypatch):
    """The fold's lowest count plane comes out inverted: every count moves
    by one."""
    import raxtax_tpu_torch.engine.device as device

    orig = device.fold_planes

    def fold(*a, **k):
        planes = orig(*a, **k).clone()
        planes[:, 0] ^= -1
        return planes

    monkeypatch.setattr(device, "fold_planes", fold)
    r = run(root)
    assert r["correct"] is False and r["check"]["lines_differ"]["value"] > 0
