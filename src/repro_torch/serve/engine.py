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

Caches are updated in place: where the JAX engine donated its cache
buffers to each jitted step, this engine writes new K/V rows into the
cache tensors it holds and admits a prefilled request by copying its
batch-1 caches into a decode lane.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import ModelConfig, api
from repro_torch.nn import plan_context
from repro_torch.plan import ExecutionPlan, execution_stream
from repro_torch.plan.compiler import check_plan_for_config


class ServeEngine:
    """Model + plan pair + phase steps behind the scheduler.

    ``n_slots`` is the fixed decode width; ``prompt_bucket`` rounds prompt
    lengths up to a multiple (token 0 padding: the padded K/V sits beyond
    each lane's valid horizon and is overwritten as decoding proceeds).
    The device is the one the parameters live on.
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
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet "
                "(ROADMAP.md, Queue A item 12)")
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
        self.prompt_bucket = int(prompt_bucket)
        self.prefill_plan = prefill_plan
        self.decode_plan = decode_plan
        self._plan_backend = plan_backend
        self._m = api(cfg, device=self.device)  # leaves the installed plan alone

    def padded_len(self, prompt_len: int) -> int:
        b = self.prompt_bucket
        return -(-prompt_len // b) * b

    def prefill_request(self, prompt: Sequence[int]):
        """Prefill one prompt at batch 1 under the prefill plan.

        Returns ``(last_logits (V,) np.ndarray, batch-1 caches)``, the
        logits taken at the last real token of the bucket-padded prompt.
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
        return logits[0, p - 1].cpu().numpy(), caches

    def fresh_caches(self):
        """Zeroed width-``n_slots`` decode caches."""
        return self._m.init_caches(self.n_slots, self.max_seq)

    def admit(self, caches, small, slot: int):
        """Copy prefilled batch-1 caches into decode lane ``slot`` (in place)."""
        for big_l, small_l in zip(caches, small):
            big_l.k[slot].copy_(small_l.k[0])
            big_l.v[slot].copy_(small_l.v[0])
        return caches

    def decode(self, tok: np.ndarray, pos: np.ndarray, caches):
        """One fixed-width decode step under the decode plan.

        ``tok``/``pos`` are ``(n_slots,)`` host arrays (free lanes pass 0).
        Returns ``(logits (n_slots, V) np.ndarray, caches)``; the caches are
        updated in place.
        """
        with plan_context(self.decode_plan, force_backend=self._plan_backend):
            with execution_stream("decode"):
                logits, caches = self._m.decode_step(
                    self.params,
                    torch.as_tensor(np.asarray(tok, np.int64)[:, None],
                                    device=self.device),
                    caches,
                    torch.as_tensor(np.asarray(pos, np.int64), device=self.device))
        return logits.cpu().numpy(), caches
