"""The port's eager decode baseline (DecodeEngine(fused=False)) against
the JAX package's eager loop and the port's fused step, with slot churn
(admit, evict mid-stream) and a warm prefix admission, on the dense, MoE,
SSM, hybrid, encoder-decoder and VLM families.

Greedy tokens must be equal on all three paths. The eager step batches
the active slots only and builds their block table per step; it writes
the pool in place, once per step.
"""
import numpy as np
import pytest
import torch

from parity_utils import BS, admit
from repro.serving.engine import DecodeEngine as JaxDecode
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.kvcache import PagedKVPool as JaxPool
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.kvcache import PagedKVPool
from torch_parity import both_params, bursts, prompts

FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "pixtral-12b", "whisper-base"]


def _frames(cfg, rng, n):
    if not cfg.is_encoder_decoder:
        return None
    return [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
             ).astype(np.float32) for _ in range(n)]


def _churn(jax_side, cfg, params, outs, *, fused):
    """Admit 0, 1; three steps; admit 2; two steps; evict 0; three
    steps: {rid: tokens} (JAX's fused-vs-eager churn schedule)."""
    if jax_side:
        pool = JaxPool(cfg, num_blocks=48, block_size=BS)
        de = JaxDecode(cfg, params, pool, max_slots=3, fused=fused)
    else:
        pool = PagedKVPool(cfg, num_blocks=48, block_size=BS, device="cpu")
        de = DecodeEngine(cfg, params, pool, max_slots=3, fused=fused)
    gen = {rid: [out.first_token] for rid, out in enumerate(outs)}

    def steps(n):
        for _ in range(n):
            for slot, burst in bursts(de.step()).items():
                gen[de.rid[slot]].extend(burst)

    slot0 = admit(pool, de, 0, outs[0])
    admit(pool, de, 1, outs[1])
    steps(3)
    admit(pool, de, 2, outs[2])
    steps(2)
    de.evict(slot0)
    pool.release(0)
    steps(3)
    if not jax_side:
        assert (de.eager_steps, de.fused_steps) == \
            ((0, 8) if fused else (8, 0))
        assert pool.invariant_ok()
    return gen


@pytest.mark.parametrize("arch", FAMILIES)
def test_eager_matches_fused_and_jax_with_slot_churn(arch):
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(5)
    toks = prompts(cfg.vocab_size, rng, rng.integers(5, 14, 3))
    frames = _frames(cfg, rng, 3)
    j_outs = JaxPrefill(cfg, jp).run(toks, frames=frames)
    p_outs = PrefillEngine(pcfg, tp).run(toks, frames=frames)
    want = _churn(True, cfg, jp, j_outs, fused=False)
    eager = _churn(False, pcfg, tp, p_outs, fused=False)
    fused = _churn(False, pcfg, tp, p_outs, fused=True)
    assert eager == want, arch
    assert fused == eager, arch


def test_eager_matches_on_warm_prefix_admission():
    """A suffix-only prefill's stitched KV feeds eager and fused decode
    on the port and JAX's eager loop: equal streams."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    rng = np.random.default_rng(11)
    prefix, suffix = prompts(cfg.vocab_size, rng, [8, 5])
    pe = PrefillEngine(pcfg, tp)
    cold, = pe.run([prefix + suffix])
    warm = pe.run_suffix(suffix, torch.cat([cold.k[:, :8], cold.v[:, :8]],
                                           dim=-1))
    assert warm.first_token == cold.first_token
    jpe = JaxPrefill(cfg, jp)
    jcold, = jpe.run([prefix + suffix])
    import jax.numpy as jnp
    jwarm = jpe.run_suffix(suffix, jnp.concatenate(
        [jcold.k[:, :8], jcold.v[:, :8]], axis=-1))
    gens = {}
    for name, c, p, out in (("jax", cfg, jp, jwarm), ("eager", pcfg, tp, warm),
                            ("fused", pcfg, tp, warm)):
        if name == "jax":
            pool = JaxPool(c, num_blocks=48, block_size=BS)
            de = JaxDecode(c, p, pool, max_slots=2, fused=False)
        else:
            pool = PagedKVPool(c, num_blocks=48, block_size=BS, device="cpu")
            de = DecodeEngine(c, p, pool, max_slots=2,
                              fused=name == "fused")
        admit(pool, de, 0, out)
        gens[name] = [out.first_token] + [
            bursts(de.step())[0][0] for _ in range(5)]
    assert gens["eager"] == gens["jax"] == gens["fused"]


def test_eager_writes_the_pool_in_place_once_per_step():
    _, _, pcfg, tp = both_params("granite-3-8b")
    rng = np.random.default_rng(1)
    outs = PrefillEngine(pcfg, tp).run(prompts(pcfg.vocab_size, rng, [6, 9]))
    pool = PagedKVPool(pcfg, num_blocks=48, block_size=BS, device="cpu")
    de = DecodeEngine(pcfg, tp, pool, max_slots=4, fused=False)
    for rid, out in enumerate(outs):
        admit(pool, de, rid, out, room=2)
    ptr, base = pool.storage.data_ptr(), pool.storage_writes
    for _ in range(2):
        de.step()
    assert pool.storage.data_ptr() == ptr
    assert pool.storage_writes - base == 2
    # a step past the allocation fails loudly instead of clamping
    for _ in range(4):
        try:
            de.step()
        except IndexError as e:
            assert "outside its" in str(e)
            break
    else:
        raise AssertionError("no IndexError past the allocation")
