"""Phase-split serving engine: batch-1 prefill + fixed-width decode.

Port of ``src/repro/serve/engine.py``.

Bit-exactness contract
----------------------
Both serving modes share one structural shape: every prompt prefills
alone at batch 1 (bucket-padded), and every decode step runs at the fixed
slot width ``n_slots`` with a per-lane ``(B,)`` cache position (free
lanes idle at position 0).  A lane's result depends only on its own cache
row, token and position, and no kernel result depends on the other rows
of its launch, so one-shot serving (concurrency 1 on the same engine) and
continuous batching produce identical per-request token ids.

Phase-specialized plans
-----------------------
Each phase's calls run under :func:`repro_torch.nn.plan_context` with its
own plan and inside :func:`repro_torch.plan.execution_stream`.  Plans are
validated against the model config (and their ``phase`` stamp) at
construction.

Across ranks
------------
Built under sharding rules whose batch axes divide ``n_slots``
(``launch/mesh.py::batch_layout``), a rank holds the lanes ``[r n/dp,
(r+1) n/dp)`` of every cache leaf (the batch entries of
``cache_shardings``), and :meth:`ServeEngine.decode` runs those lanes
under the rules' ``batch_split`` and returns the whole ``(n_slots, V)``
logits through one all-gather over the batch axes, so the host scheduler,
which every rank runs the same way, samples identically.  The batch-1
prefill runs on every rank, replicated as in the reference (a planned
projection splits its tokens), and :meth:`ServeEngine.admit` keeps a
lane only on the rank that owns it.  Where the batch axes do not divide
``n_slots`` every rank holds every lane.  On a model axis over 1 a rank's
caches hold its block of the kv heads and of the SSM and WKV states'
heads where they divide the axis (the model entries of
``cache_shardings`` that ``applied_cache_shardings`` applies), the
prefill writes that block and ``admit`` copies it; the logits, a block of
the vocab on each rank, are gathered over the model axis before the
host samples them, so the scheduler still sees ``(n_slots, V)``.

Under SP (every family but RWKV where the rules' ``seq_axis`` is set) a
bucketed prompt whose length the model axis divides prefills as each
rank's block of its positions, the logits' positions gathered
(``models/lm.py``; the hybrid's scan hands its state from rank to rank
and stores the whole prompt's state and conv history), and one that does
not stays whole.  Where the caches' positions take the axis
(``kv_layout``: ``_cache_pspec``'s ``seq`` entry) a rank holds its block
of every lane's positions, and elsewhere its block of the kv heads (and
of the SSM heads) as a decode step holds them: the prefill writes the
part of the prompt in it, a decode step combines the ranks'
blocks of the attention (``nn/attention.py``), and every rank ends with
the same logits, so the host scheduler samples the same tokens.

Caches: where the JAX engine donated its cache buffers to each jitted
step, attention layers here write new K/V rows into the cache tensors in
place, recurrent layers (Mamba2, RWKV6) return new state tensors, and a
prefilled request is admitted by copying every leaf of its batch-1 cache
tree into a decode lane.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import LayoutBlocks, applied_cache_shardings, batch_layout
from repro_torch.models import ModelConfig, api
from repro_torch.models.lm import whole_logits
from repro_torch.nn import plan_context
from repro_torch.plan import ExecutionPlan, execution_stream
from repro_torch.plan.compiler import check_plan_for_config
from repro_torch.plan.sharded import batch_axes_split, collective
from repro_torch.sharding import get_rules, kv_layout, use_rules
from repro_torch.tree import leaves


class ServeEngine:
    """Model + plan pair + phase steps behind the scheduler.

    ``n_slots`` is the fixed decode width; ``prompt_bucket`` rounds prompt
    lengths up to a multiple (token 0 padding: the padded K/V sits beyond
    each lane's valid horizon and is overwritten as decoding proceeds;
    recurrent-state families force a bucket of 1, since padding tokens
    would advance their state).  The device is the one the parameters live
    on.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        n_slots: int,
        max_seq: int,
        prompt_bucket: int = 8,
        prefill_plan: Optional[ExecutionPlan] = None,
        decode_plan: Optional[ExecutionPlan] = None,
        arch: str = "",
        plan_backend: Optional[str] = None,
    ) -> None:
        if cfg.family == "encdec":
            raise ValueError(
                "serve scheduler is causal-LM only: encdec runs its own "
                "scalar-position decoder (serve it through the prefill/decode "
                "steps, launch.steps.make_prefill_step / make_decode_step, as "
                "examples/serve_decode_torch.py does)")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1 (got {n_slots})")
        if prompt_bucket < 1:
            raise ValueError(f"prompt_bucket must be >= 1 (got {prompt_bucket})")
        if arch:
            for plan, phase in ((prefill_plan, "prefill"),
                                (decode_plan, "decode")):
                if plan is None:
                    continue
                problems = check_plan_for_config(plan, arch, cfg, phase=phase)
                if problems:
                    raise ValueError(
                        f"{phase} plan rejected for arch {arch!r}:\n  "
                        + "\n  ".join(problems))
        # v4 factorizations set parameter shapes: both phases contract the
        # same params, so the pair must carry one decomposition
        fact = {
            phase: {lp.name: lp.factorization.triple
                    for lp in plan.layers if lp.factorization is not None}
            for plan, phase in ((prefill_plan, "prefill"),
                                (decode_plan, "decode"))
            if plan is not None
        }
        if any(fact.values()):
            if prefill_plan is None or decode_plan is None:
                raise ValueError(
                    "a plan with searched factorizations (schema v4) must "
                    "install for BOTH phases: the unplanned phase would "
                    "contract default-decomposition networks over "
                    "factorized params")
            if fact["prefill"] != fact["decode"]:
                diff = sorted(
                    set(fact["prefill"].items())
                    ^ set(fact["decode"].items()))
                raise ValueError(
                    "prefill/decode plans carry different factorizations "
                    f"({[n for n, _ in diff]}); a serving pair shares one "
                    "decomposition (it defines the parameter shapes)")
        self.cfg = cfg
        self.params = params
        self.device = params["ln_f"]["scale"].device
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        # padding would advance recurrent state: exact lengths only
        self.prompt_bucket = 1 if cfg.supports_long_context else int(prompt_bucket)
        self.prefill_plan = prefill_plan
        self.decode_plan = decode_plan
        self._plan_backend = plan_backend
        self._m = api(cfg, device=self.device)  # leaves the installed plan alone
        # the decode lanes of this rank: [lo, hi) under the rules' batch
        # split of n_slots, every lane otherwise
        rules = get_rules()
        self._decode_rules = (kv_layout(batch_layout(rules, self.n_slots), cfg.family,
                                        cfg.n_kv_heads, self.max_seq)
                              if rules is not None else None)
        split = batch_axes_split(self._decode_rules)
        self._group = None
        self.lanes = (0, self.n_slots)
        if split is not None:
            self._group, index, n = split
            per = self.n_slots // n
            self.lanes = (index * per, (index + 1) * per)

    def padded_len(self, prompt_len: int) -> int:
        b = self.prompt_bucket
        return -(-prompt_len // b) * b

    def prefill_request(self, prompt: Sequence[int]):
        """Prefill one prompt at batch 1 under the prefill plan.

        Returns ``(last_logits (V,) np.ndarray, batch-1 caches)``, the
        logits taken at the last real token of the bucket-padded prompt
        (in fp32: a bf16 model's logits widen exactly).
        """
        p = len(prompt)
        pp = self.padded_len(p)
        if pp > self.max_seq:
            raise ValueError(
                f"padded prompt length {pp} exceeds max_seq {self.max_seq}")
        toks = np.zeros((1, pp), np.int64)
        toks[0, :p] = np.asarray(prompt, np.int64)
        with plan_context(self.prefill_plan, force_backend=self._plan_backend):
            with execution_stream("prefill"):
                logits, caches = self._m.prefill_full(
                    self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
                    self.max_seq)
                row = whole_logits(logits[:, p - 1], self.cfg.vocab)
        return row[0].float().cpu().numpy(), caches

    def fresh_caches(self):
        """Zeroed decode caches of this rank's lanes (every lane on one
        rank) and heads, the rank's block of the width-``n_slots``
        caches' ``applied_cache_shardings``."""
        lo, hi = self.lanes
        rules = self._decode_rules
        with use_rules(rules):
            caches = self._m.init_caches(hi - lo, self.max_seq)
        if rules is not None and rules.mesh is not None:
            with use_rules(None):
                whole = api(self.cfg, device="meta").init_caches(self.n_slots,
                                                                 self.max_seq)
            blocks = LayoutBlocks(applied_cache_shardings(self.cfg, whole, rules),
                                  rules)
            want = [t.shape for t in leaves(blocks.block(whole))]
            got = [t.shape for t in leaves(caches)]
            if want != got:
                raise ValueError(f"lanes {self.lanes} of {self.n_slots}: cache "
                                 f"leaves {got} are not the layout's blocks {want}")
        return caches

    def admit(self, caches, small, slot: int):
        """Copy a prefilled batch-1 cache tree into decode lane ``slot``:
        every leaf (K/V rows, SSM and RWKV states), in place, on the rank
        that holds the lane."""
        lo, hi = self.lanes
        if lo <= slot < hi:
            _copy_lane(caches, small, slot - lo)
        return caches

    def decode(self, tok: np.ndarray, pos: np.ndarray, caches):
        """One fixed-width decode step under the decode plan.

        ``tok``/``pos`` are ``(n_slots,)`` host arrays (free lanes pass 0).
        Returns ``(logits (n_slots, V) np.ndarray, caches)``: K/V rows are
        written in place, recurrent states are new, so the caller uses the
        returned tree.  A rank runs its lanes; the logits are gathered
        over the model axis (the vocab) and over the batch axes (every
        lane).
        """
        lo, hi = self.lanes
        with plan_context(self.decode_plan, force_backend=self._plan_backend):
            with execution_stream("decode"), (
                    use_rules(self._decode_rules) if self._decode_rules is not None
                    else contextlib.nullcontext()):
                logits, caches = self._m.decode_step(
                    self.params,
                    torch.as_tensor(np.asarray(tok, np.int64)[lo:hi, None],
                                    device=self.device),
                    caches,
                    torch.as_tensor(np.asarray(pos, np.int64)[lo:hi],
                                    device=self.device))
                logits = whole_logits(logits, self.cfg.vocab)
        if self._group is not None:
            logits = collective("all_gather", logits, self._group)
        return logits.float().cpu().numpy(), caches


def _copy_lane(big, small, slot: int) -> None:
    """``big_leaf[slot] = small_leaf[0]`` over two cache trees of one
    structure (lists, dicts and named tuples of tensors; batch on axis 0)."""
    if isinstance(big, torch.Tensor):
        big[slot].copy_(small[0])
    elif isinstance(big, dict):
        for k in big:
            _copy_lane(big[k], small[k], slot)
    else:
        for b, s in zip(big, small, strict=True):
            _copy_lane(b, s, slot)
