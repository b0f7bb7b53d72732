"""The rest of a run, with the timed path broken underneath, comes out not
correct: once for each fault a served cell can have. (Leaving half of a
batch out and averaging over the rest is a training step's fault; a
served cell has no such mean.)"""
import pytest
import torch

from pdbench.tests import tiny
from repro_torch.serving.cluster import DecodeNode
from repro_torch.serving.kvcache import PagedKVPool


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("pdbench"))


def _state_unchanged(monkeypatch):
    """A decode step that leaves its state as it found it: the KV pool and
    the slots' tokens and positions."""
    step = DecodeNode.step

    def faulty(self):
        e = self.engine
        kept = [t.clone() for t in (self.pool.full_storage, e._tokens,
                                    e._pos)]
        out = step(self)
        for t, k in zip((self.pool.full_storage, e._tokens, e._pos), kept):
            t.copy_(k)
        return out
    monkeypatch.setattr(DecodeNode, "step", faulty)


def _no_exchange(monkeypatch):
    """The KV hand-off from the prefill node's pool to the decode node's
    left out."""
    monkeypatch.setattr(PagedKVPool, "scatter_layer",
                        lambda self, buf, blocks, layer: None)


def _token_altered(monkeypatch):
    """Every decode step serves a different token than it computed in its
    first active slot."""
    step = DecodeNode.step
    eng_step = None

    def faulty(self):
        nonlocal eng_step
        real = self.engine.step

        def altered():
            res = real()
            for slot in list(res)[:1]:
                res[slot] = [(t + 1) % self.cfg.vocab_size
                             for t in res[slot]]
            return res
        self.engine.step = altered
        try:
            return step(self)
        finally:
            self.engine.step = real
    monkeypatch.setattr(DecodeNode, "step", faulty)


@pytest.mark.parametrize("fault", [_state_unchanged, _no_exchange,
                                   _token_altered])
@pytest.mark.parametrize("workload", ["tiny.tiny-chat",
                                      "tiny-moe.tiny-unshared"])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault, workload):
    fault(monkeypatch)
    _, rec, out = tiny.run(root, workload, seed=23)
    assert out["correct"] is False
    assert out["check"]["logit_gap_max"]["value"] > \
        out["check"]["logit_gap_max"]["limit"]


def test_the_same_run_unbroken_is_correct(root):
    _, rec, out = tiny.run(root, "tiny.tiny-chat", seed=23)
    assert out["correct"] is True
    assert rec.check["logit_gap_max"] <= \
        tiny.TINY_CONFIG["checks"]["logit_gap_max"]
    assert rec.check["mismatch_share"] == 0.0
    assert torch.get_default_dtype() == torch.float32
