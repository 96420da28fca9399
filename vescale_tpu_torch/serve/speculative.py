"""Speculative decoding — draft-then-verify with a reduced-depth drafter.

The port of ``vescale_tpu/serve/speculative.py`` (Leviathan et al.,
arXiv:2211.17192): a cheap DRAFTER proposes ``k`` tokens autoregressively,
the target scores all of them in ONE multi-token paged step
(``ServeEngine.decode_multi``, width ``k + 1``), and greedy acceptance keeps
every draft token that equals the target's own argmax.  Every emitted token
is the target's argmax, so the stream is the one plain decode would give;
the drafter only decides how many target steps it takes.

The drafter is the SAME model at reduced depth: the first
``drafter_layers`` decoder blocks plus the shared embedding, final norm and
head (:func:`slice_drafter_params`).  It is a port :class:`ServeEngine` on
the target's device over its own :class:`PagedKVCache` with the target's
slot and page geometry and fewer layers; its weights are the target's own
tensors (placing a tensor already on the device copies nothing), and on the
card its decode step is a CUDA graph of its own.

Cache discipline: the drafter mirrors the target's slot lifecycle (the loop
calls :meth:`SpeculativeDecoder.admit` after each target admission and
:meth:`SpeculativeDecoder.sync_slots` at each boundary).  While drafting it
appends K/V for its own proposals; after verification
:meth:`SpeculativeDecoder.rewind` rolls its lengths back to the target's
committed lengths, so rejected positions become uncommitted bytes the next
write overwrites.  The target's verify writes K/V for all ``k + 1``
positions too; only the accepted ones are committed via ``cache.advance``.

Not in this slice: ``load_drafter_params`` and ``drafter_template`` (they
restore from a checkpoint) and ``suggested_k`` (it reads the calibration
table of the telemetry layer): a ``k`` below 1 raises where the JAX package
would consult that table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import config as _config
from .engine import ServeEngine, _as_tree
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache

__all__ = ["SpeculativeDecoder", "drafter_config", "drafter_template", "load_drafter_params",
           "slice_drafter_params"]


def drafter_config(config, layers: int):
    """The target's ``LlamaConfig`` truncated to its first ``layers``
    decoder blocks (embedding, norm and head shared)."""
    if not (1 <= layers <= config.num_hidden_layers):
        raise ValueError(
            f"drafter_layers={layers} not in [1, {config.num_hidden_layers}]"
        )
    return dataclasses.replace(config, num_hidden_layers=layers)


def slice_drafter_params(params: Dict[str, Any], layers: int) -> Dict[str, Any]:
    """The drafter's tree: the first ``layers`` blocks and the shared
    embed/norm/head of a full target tree, the same leaves (no copy)."""
    params = _as_tree(params)
    out = {k: v for k, v in params.items() if not k.startswith("layers_")}
    for l in range(layers):
        key = f"layers_{l}"
        if key not in params:
            raise ValueError(f"params missing {key} (drafter_layers={layers})")
        out[key] = params[key]
    return out


def drafter_template(config, layers: int, dtype=None) -> Dict[str, Any]:
    """The params-only restore template of a ``layers``-deep drafter:
    tensors on ``meta`` (``dtype``, default the config's) naming only the
    drafter's subtree, so ``checkpoint.load`` never reads the deeper layers
    (nor the optimizer)."""
    from ..models import init_params

    return init_params(drafter_config(config, layers), device="meta", dtype=dtype)


def load_drafter_params(path: str, config, layers: int, *, device=None,
                        dtype=None) -> Dict[str, Any]:
    """Restore the drafter's subtree (the first ``layers`` blocks, the
    embedding, norm and head) from a training checkpoint through the elastic
    preflight, onto ``device`` (default: the card)."""
    from .. import checkpoint as ckpt

    return ckpt.load(path, {"model": drafter_template(config, layers, dtype)},
                     device=device)["model"]


class SpeculativeDecoder:
    """Drafter engine + cache mirror + the greedy accept bookkeeping, handed
    to ``run_serve(speculative=...)``.  ``k`` and ``drafter_layers`` default
    to ``VESCALE_SPEC_K`` and ``VESCALE_SPEC_DRAFTER_LAYERS``."""

    def __init__(
        self,
        engine: ServeEngine,
        drafter_params: Dict[str, Any],
        *,
        drafter_layers: Optional[int] = None,
        k: Optional[int] = None,
    ):
        if k is None:
            k = _config.get_int("VESCALE_SPEC_K")
        if not k or k < 1:
            raise ValueError(
                f"speculative k must be >= 1, got {k} (the calibrated suggestion "
                "of the JAX package comes with the telemetry layer)"
            )
        if drafter_layers is None:
            drafter_layers = _config.get_int("VESCALE_SPEC_DRAFTER_LAYERS")
        self.k = int(k)
        tc = engine.cache.config
        dcfg = drafter_config(engine.config, int(drafter_layers))
        self.cache = PagedKVCache(
            KVCacheConfig(
                layers=dcfg.num_hidden_layers,
                kv_heads=tc.kv_heads,
                head_dim=tc.head_dim,
                num_slots=tc.num_slots,
                page_size=tc.page_size,
                pages_per_slot=tc.pages_per_slot,
                num_pages=tc.num_pages,
                dtype=engine.cache.dtype,
            ),
            device=engine.device,
        )
        self.engine = ServeEngine(dcfg, drafter_params, self.cache, device=engine.device)
        # drafted counts every proposed token that HAD a chance to be
        # accepted (budget-clamped proposals excluded by the loop), accepted
        # only those the target confirmed
        self.drafted = 0
        self.accepted = 0
        self.verify_steps = 0
        # slots the drafter could NOT mirror (its pool allocates every
        # slot's full page need, so target-side prefix sharing can admit
        # more than it holds): they go through the verify step with zero
        # drafts, one correct token a step, and stay out of the accounting
        self.undrafted: set = set()

    def accept_rate(self) -> Optional[float]:
        """Fraction of drafted tokens the target accepted; None before the
        first verify."""
        if not self.drafted:
            return None
        return self.accepted / self.drafted

    # ------------------------------------------------------ slot lifecycle
    def on_admit(self, slot: int, prompt: Sequence[int], max_new_tokens: int) -> None:
        """Mirror a target admission: reserve the SAME slot id in the
        drafter cache and run the drafter's own full prefill (the drafter
        never consults the prefix tree)."""
        self.cache.alloc(len(prompt), max_new_tokens, slot=slot)
        self.engine.prefill(prompt, slot)
        self.cache.commit_prefill(slot, len(prompt))

    def admit(self, slot: int, prompt: Sequence[int], max_new_tokens: int) -> bool:
        """The loop's admission hook: :meth:`on_admit`, degrading to an
        UNDRAFTED slot when the drafter pool is out of pages."""
        self.undrafted.discard(slot)
        try:
            self.on_admit(slot, prompt, max_new_tokens)
            return True
        except KVCacheOutOfPages:
            self.undrafted.add(slot)
            return False

    def sync_slots(self, live_slots: Iterable[int]) -> None:
        """Free drafter slots whose target slot ended since the last
        boundary."""
        live = set(live_slots)
        for slot in self.cache.active_slots():
            if slot not in live:
                self.cache.free(slot)
        self.undrafted &= live

    def drafted_slots(self, active_slots: Sequence[int]) -> List[int]:
        """The active slots the drafter mirrors."""
        return [s for s in active_slots if s not in self.undrafted]

    # ------------------------------------------------------------ drafting
    def draft(self, last_tokens: Sequence[int], active_slots: Sequence[int]) -> np.ndarray:
        """Propose ``k`` tokens per active slot with ``k + 1`` drafter
        decode steps from each slot's last sampled token: the last step
        writes the final draft's K/V (its token is discarded), so on full
        acceptance the drafter cache covers every position the target
        committed.  Drafter lengths advance as it goes (rewound after the
        verify); a drafter past its reserved pages keeps proposing into the
        null page, and the verify rejects what it proposes."""
        S = self.cache.num_slots
        cur = [int(t) for t in last_tokens]
        drafts = np.zeros((S, self.k), np.int64)
        for i in range(self.k + 1):
            logits = self.engine.decode(cur)
            for slot in active_slots:
                if self.cache.can_advance(slot):
                    self.cache.advance(slot)
                if i < self.k:
                    t = int(np.argmax(logits[slot]))
                    drafts[slot, i] = t
                    cur[slot] = t
        return drafts

    def rewind(self, target_lengths: np.ndarray, active_slots: Sequence[int]) -> None:
        """After the verify: roll every active drafter slot back to the
        target's committed length."""
        for slot in active_slots:
            want = int(target_lengths[slot])
            have = int(self.cache.lengths[slot])
            if want <= have:
                self.cache.rollback(slot, want)
            else:
                # a drafter that stopped short of the target's commit catches
                # its length up; those positions hold stale K/V, which can
                # cost acceptance but never correctness
                while int(self.cache.lengths[slot]) < want and self.cache.can_advance(slot):
                    self.cache.advance(slot)

    # ------------------------------------------------------------ accepting
    def accept(
        self,
        drafts_row: np.ndarray,
        verify_logits_row: np.ndarray,
        budget: int,
        eos_id: Optional[int],
    ) -> Tuple[List[int], int]:
        """Greedy acceptance for one slot: the longest prefix of the ``k``
        drafts that equals the target's argmax at each position, then the
        target's own next token, clamped by the remaining token ``budget``
        and cut after ``eos_id``.  Returns (emitted tokens, accepted draft
        count)."""
        k = self.k
        greedy = [int(np.argmax(verify_logits_row[i])) for i in range(k + 1)]
        matched = 0
        while matched < k and int(drafts_row[matched]) == greedy[matched]:
            matched += 1
        emitted: List[int] = []
        for i in range(matched + 1):  # accepted drafts + the bonus token
            if len(emitted) >= budget:
                break
            emitted.append(greedy[i])
            if eos_id is not None and greedy[i] == eos_id:
                break
        return emitted, min(matched, len(emitted))
