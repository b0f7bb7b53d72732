"""Disaggregated speculative decoding (paper §6.1, Discussion/Extension).

Counterpart of ``src/repro/serving/speculative.py``. A small draft model
proposes k tokens autoregressively; the target verifies them in one
teacher-forced sweep over the k+1 new positions, and the longest matching
prefix is accepted (greedy speculation is lossless: the output equals
target-only greedy decoding).

As in the paper, the draft is disaggregated WITH the large model: its
decode state lives on the decode node, which prefills the draft at
admission. ``SpeculativeDecoder`` is the b=1 reference oracle over dense
caches (``models.modeling.forward_decode``); the serving path is the
multi-slot step ``models.modeling.forward_spec_decode_step`` driven by
``DecodeEngine(spec=...)``, held to this oracle and to plain greedy
decode by test.

The port's dense caches are written in place (``forward_decode``), so
the oracle keeps CLONES as its rollback points where JAX keeps the old
immutable trees: the draft's snapshot before proposing, and the target's
cache after each verify position.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.modeling import forward_decode, forward_prefill
from repro_torch.models.params import (block_period, init_params, num_blocks,
                                       tree_map)

Tree = Dict[str, Any]


def _pad_cache(cache: Tree, new_s: int) -> Tree:
    """The attention caches ("k", "v" (nblk, b, s, kv_dim)) zero-padded to
    ``new_s`` rows; every other leaf kept."""
    def pad(tree: Tree) -> Tree:
        out = {}
        for name, x in tree.items():
            if isinstance(x, dict):
                out[name] = pad(x)
            elif name in ("k", "v") and x.dim() == 4:
                out[name] = F.pad(x, (0, 0, 0, new_s - x.shape[2]))
            else:
                out[name] = x
        return out
    return {"layers": pad(cache["layers"]), "pos": cache["pos"]}


def _clone(cache: Tree) -> Tree:
    return {"layers": tree_map(lambda x: x.clone(), cache["layers"]),
            "pos": cache["pos"]}


@dataclass
class SpecConfig:
    """Draft-model binding for speculative decode: which small model
    proposes, and how deep it speculates per target verification."""
    draft_cfg: ModelConfig
    draft_params: Tree
    k: int = 4


# Scenario tag -> speculation depth for the auto-picked draft: grouping by
# scenario keeps output-length statistics similar inside a group (§3.2),
# so long-generation scenarios amortize deeper speculation.
SCENARIO_SPEC_K = {"default": 4, "chat": 4, "qa": 3, "summarize": 2,
                   "write": 6}

# Most layer blocks the auto-picked draft keeps (the JAX package's default).
DRAFT_MAX_BLOCKS = 2


def draft_for(cfg: ModelConfig, scenario: str = "default", *,
              seed: int = 0, device: DeviceLike = "cuda") -> SpecConfig:
    """Scenario-aware draft choice (paper §6.1 co-located deployment): the
    same family at a fraction of the depth (whole layer blocks, so hybrid
    periods stay intact), the same vocabulary (acceptance compares token
    ids), random params from a torch generator seeded with ``seed`` on
    ``device``. Its config equals the JAX package's; its numbers do not
    (compare the two through ``params_from_numpy``)."""
    dev = resolve_device(device)
    per = block_period(cfg)
    n_blk = max(1, min(DRAFT_MAX_BLOCKS, num_blocks(cfg) // 4))
    d_cfg = cfg.replace(num_layers=n_blk * per,
                        name=f"{cfg.name}-draft{n_blk * per}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d_params = init_params(d_cfg, gen, device=dev)
    return SpecConfig(d_cfg, d_params,
                      k=SCENARIO_SPEC_K.get(scenario,
                                            SCENARIO_SPEC_K["default"]))


@dataclass
class SpecStats:
    proposed: int = 0        # draft tokens proposed
    accepted: int = 0        # draft tokens accepted by the target
    emitted: int = 0         # tokens emitted (corrections and the
    #                          all-accepted bonus token included)
    target_steps: int = 0    # target verification sweeps (+ prefill)
    draft_replay_tokens: int = 0  # rollback replays through the draft

    @property
    def acceptance(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_step(self) -> float:
        """Emitted tokens per target sweep, exactly: the bonus token of an
        all-accepted round and the correction of a rejection count, the
        truncation at max_new_tokens is subtracted back out."""
        return self.emitted / self.target_steps if self.target_steps \
            else 0.0


class SpeculativeDecoder:
    """Greedy speculative decoding for one sequence (b=1 oracle)."""

    def __init__(self, target_cfg: ModelConfig, target_params: Tree,
                 draft_cfg: ModelConfig, draft_params: Tree, *, k: int = 4):
        if target_cfg.is_encoder_decoder:
            raise ValueError("speculative decode does not cover enc-dec "
                             "families")
        self.tc, self.tp = target_cfg, target_params
        self.dc, self.dp = draft_cfg, draft_params
        self.k = k
        self.stats = SpecStats()
        self.device = target_params["embed"].device

    def _tok(self, t: int) -> torch.Tensor:
        return torch.tensor([t], dtype=torch.int32, device=self.device)

    def generate(self, prompt: List[int], max_new_tokens: int) -> List[int]:
        """Returns the generated tokens (equal to target greedy)."""
        out: List[int] = []
        horizon = len(prompt) + max_new_tokens + self.k + 2
        batch = {"tokens": torch.tensor([list(prompt)], dtype=torch.int32,
                                        device=self.device)}
        t_first, t_cache = forward_prefill(self.tc, self.tp, batch)
        t_cache = _pad_cache(t_cache, horizon)
        _, d_cache = forward_prefill(self.dc, self.dp, batch)
        d_cache = _pad_cache(d_cache, horizon)
        cur = int(t_first[0])
        out.append(cur)
        self.stats.target_steps += 1
        self.stats.emitted += 1
        # invariant at the top of each round: both caches have consumed
        # exactly prompt + out[:-1]; the last emitted token is in flight
        while len(out) < max_new_tokens:
            # 1. the draft proposes k tokens from the current context
            proposal: List[int] = []
            d_tok = self._tok(cur)
            d_snapshot = _clone(d_cache)               # rollback point
            for _ in range(self.k):
                d_tok, d_cache = forward_decode(self.dc, self.dp, d_cache,
                                                d_tok)
                proposal.append(int(d_tok[0]))
            self.stats.proposed += len(proposal)
            # 2. the target teacher-forces the k+1 new positions; g[i] is
            #    its greedy token after position i, and the cache after
            #    each position is that depth's rollback point
            g: List[int] = []
            t_steps: List[Tree] = []
            for tok in [cur] + proposal:
                gt, t_cache = forward_decode(self.tc, self.tp, t_cache,
                                             self._tok(tok))
                g.append(int(gt[0]))
                t_steps.append(_clone(t_cache))
            self.stats.target_steps += 1
            accepted = 0
            while accepted < self.k and proposal[accepted] == g[accepted]:
                accepted += 1
            self.stats.accepted += accepted
            # accepted proposals equal the target's own tokens, so the
            # emission is g[:accepted+1]: the last is the correction on a
            # rejection, the bonus token when all k were accepted
            emit = g[:accepted + 1]
            out.extend(emit)
            self.stats.emitted += len(emit)
            prev, cur = cur, emit[-1]
            # 3. restore the invariant: the target's cache at the accepted
            #    depth; the draft rolled back to its snapshot and replaying
            #    only the accepted tokens (recurrent-safe)
            t_cache = t_steps[accepted]
            d_cache = d_snapshot
            replay = [prev] + proposal[:accepted]
            for tok in replay:
                _, d_cache = forward_decode(self.dc, self.dp, d_cache,
                                            self._tok(tok))
            self.stats.draft_replay_tokens += len(replay)
        overshoot = len(out) - max_new_tokens
        if overshoot > 0:
            self.stats.emitted -= overshoot            # keep stats exact
        return out[:max_new_tokens]
