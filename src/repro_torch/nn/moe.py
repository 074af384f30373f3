"""Mixture-of-Experts FFN: capacity dispatch + shared experts (port of
``nn/moe.py``).

Routing runs in fixed-size token groups (``router_group``): each token
picks its top-k experts from an fp32 router, and the (token, choice) pairs
claim capacity slots in (token, choice) order, ``cap = max(4, min(ceil(k
g cf / E), g))`` slots per expert and group; a pair past the capacity is
dropped.  The dispatch writes each kept token into its slot (the
reference's one-hot einsum, whose sums hold one nonzero term, as an
index copy; a dropped pair writes to a spare slot past the capacity,
which is cut away); the combine gathers each token's k slot outputs and
sums them over its choices in fp32.  Neither reads the routing back to
the host: every shape is fixed by the config and the input's shape, so
the same code runs on ``meta`` (the dry run) and on a card without a
host sync.

Expert weights are stacked on a leading expert axis.  The reference runs
the experts' projections under ``jax.vmap``; here a projection planned for
a kernel backend runs every expert in one batched planned call at ``(E,
G * cap, d)`` (``nn.linear.linear_apply_batched``: one launch of each
kernel for all experts, forward and backward, the experts no kept pair
reached at zero input, as the reference's), and a projection on the plain
executor runs every expert in one ``torch.func.vmap`` call.  Shared
experts (Qwen2-MoE style) are merged into one wide always-on FFN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .linear import (
    LinearSpec,
    TTConfig,
    linear_apply,
    linear_apply_batched,
    linear_init,
    planned_layer,
    runs_on_kernels,
    shape_only,
)
from .mlp import MLPSpec, mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    name: str
    d_model: int
    d_ff: int                      # per routed expert
    n_experts: int
    top_k: int
    n_shared: int = 0              # always-on shared experts (merged)
    shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_group: int = 512        # tokens per routing group
    kind: str = "swiglu"
    tt: Optional[TTConfig] = None

    @property
    def expert_gate(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.eg", self.d_model, self.d_ff, False, "moe", self.tt)

    @property
    def expert_up(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.eu", self.d_model, self.d_ff, False, "moe", self.tt)

    @property
    def expert_down(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.ed", self.d_ff, self.d_model, False, "moe", self.tt)

    @property
    def shared_spec(self) -> Optional[MLPSpec]:
        if not self.n_shared:
            return None
        ff = self.shared_d_ff if self.shared_d_ff else self.n_shared * self.d_ff
        return MLPSpec(f"{self.name}.shared", self.d_model, ff, self.kind, self.tt)


def moe_init(spec: MoESpec, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """The router (always fp32), each expert projection stacked on a
    leading expert axis, and the merged shared FFN."""
    if shape_only(device):
        router = torch.empty((spec.d_model, spec.n_experts), device="meta")
    else:
        router = torch.randn((spec.d_model, spec.n_experts),
                             generator=generator) * 0.02
    params: dict = {"router": router.to(device)}
    specs = [("eu", spec.expert_up), ("ed", spec.expert_down)]
    if spec.kind == "swiglu":
        specs.append(("eg", spec.expert_gate))
    for nm, ls in specs:
        per_expert = [linear_init(ls, generator, dtype, device)
                      for _ in range(spec.n_experts)]
        params[nm] = {k: torch.stack([p[k] for p in per_expert])
                      for k in per_expert[0]}
    if spec.shared_spec is not None:
        params["shared"] = mlp_init(spec.shared_spec, generator, dtype, device)
    return params


def _experts_linear(spec: LinearSpec, stacked: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """One projection of every expert: ``x (E, T, d_in) -> (E, T, d_out)``,
    one batched planned call on a kernel plan, else ``torch.func.vmap``."""
    if spec.tensorized and runs_on_kernels(planned_layer(spec.name)):
        return linear_apply_batched(spec, stacked, x)
    return torch.func.vmap(lambda p, xe: linear_apply(spec, p, xe))(stacked, x)


def _experts_ffn(spec: MoESpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its ``(T, d_model)`` slots (the reference's
    ``_expert_ffn`` under ``jax.vmap``)."""
    up = _experts_linear(spec.expert_up, params["eu"], x)
    if spec.kind == "swiglu":
        gate = _experts_linear(spec.expert_gate, params["eg"], x)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return _experts_linear(spec.expert_down, params["ed"], h)


def route(spec: MoESpec, params: dict, xg: torch.Tensor):
    """The fp32 router on grouped tokens ``xg (G, g, D)``: (probs (G, g, E),
    the top-k gates renormalised to sum 1 (G, g, K), their experts)."""
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    # a stable sort breaks ties to the lower expert, as jax.lax.top_k does
    # (a padded group's zero tokens tie across every expert)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :spec.top_k], idx[..., :spec.top_k]
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), idx


def moe_apply(spec: MoESpec, params: dict,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar).

    aux_loss is the Switch/GShard load-balance loss ``E * sum_e f_e * p_e``
    (f = fraction of tokens routed to e, p = mean router prob of e).

    Under the installed rules' ``batch_split`` ``x`` is the rank's block of
    the batch, and the layer gives the reference's values on the global
    batch.  Groups of ``g = min(router_group, global tokens)`` flattened
    tokens are the reference's groups when the rank's tokens are a
    multiple of ``g``: each rank routes its own groups, and the per-expert
    sums of f and p and the row count are summed over the batch axes
    before the product (f and p are global means).  Otherwise a group
    straddles ranks: the rank gathers the whole batch over the batch axes,
    routes it as one device does and keeps its block of the output.  The
    shared experts run on the rank's block.

    Under ``seq_split`` ``x`` is also the rank's block of the positions of
    each row: where ``g`` divides the block, every group lies inside one
    rank's block of one row, the rank routes its own groups and the
    statistics are summed over the batch axes and the sequence's axis;
    otherwise the rank gathers the sequence (``seq_gather``), routes as
    above and keeps its block of the positions.
    """
    from repro_torch.plan.sharded import seq_axis_split, seq_gather, split_group
    from repro_torch.sharding import get_rules

    rules = get_rules()
    seq = seq_axis_split(rules)
    if seq is None:
        y, aux = _routed_batch(spec, params, x, rules)
    else:
        group, index, tp = seq
        b, s, _ = x.shape
        g = min(spec.router_group, rules.split_dp * b * tp * s)
        if s % g:
            y, aux = _routed_batch(spec, params, seq_gather(x, 1, seq), rules)
            y = y.narrow(1, index * s, s)
        else:
            y, aux = _routed(spec, params, x, g, split_group(rules))
    if spec.shared_spec is not None:
        y = y + mlp_apply(spec.shared_spec, params["shared"], x)
    return y, aux


def _routed_batch(spec: MoESpec, params: dict, x: torch.Tensor,
                  rules) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of :func:`moe_apply` on ``x``, the rank's block
    of the batch under ``batch_split`` and whole along the sequence."""
    from repro_torch.plan.sharded import batch_axes_split, gather_batch

    b, s, d = x.shape
    split = batch_axes_split(rules)
    if split is None:
        return _routed(spec, params, x, min(spec.router_group, b * s))
    group, index, n = split
    g = min(spec.router_group, n * b * s)
    if (b * s) % g:
        y, aux = _routed(spec, params, gather_batch(x, group, index), g)
        return y.narrow(0, index * b, b), aux
    return _routed(spec, params, x, g, group)


def _routed(spec: MoESpec, params: dict, x: torch.Tensor, g: int,
            group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of :func:`moe_apply` on ``x`` in groups of ``g``
    tokens; with ``group``, the aux loss's statistics summed over it."""
    b, s, d = x.shape
    E, K = spec.n_experts, spec.top_k
    total = b * s
    pad = (-total) % g
    xf = x.reshape(total, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))], dim=0)
    xg = xf.reshape(-1, g, d)                               # (G, g, D)
    n_groups = xg.shape[0]

    probs, gate_vals, idx = route(spec, params, xg)

    cap = int(math.ceil(K * g * spec.capacity_factor / E))
    cap = max(4, min(cap, g))

    # one-hot by comparison (no class-range check that reads data back)
    expert_oh = (idx[..., None] == torch.arange(E, device=x.device)
                 ).to(torch.float32)                        # (G, g, K, E)
    # capacity slot: pairs claim slots in (token, choice) priority order
    flat = expert_oh.reshape(-1, g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(-1, g, K, E)
    slot = torch.sum(pos * expert_oh, dim=-1).to(torch.long)  # (G, g, K)
    keep = slot < cap

    # dispatch: pair (gi, t, k) -> expert_in[gi, idx, slot] = x[gi, t]; a
    # dropped pair lands in the spare slot ``cap``, which is cut away
    gsel = torch.arange(n_groups, device=x.device)[:, None, None]
    expert_in = xg.new_zeros((n_groups, E, cap + 1, d))
    expert_in[gsel, idx, slot.clamp(max=cap)] = \
        xg[:, :, None, :].expand(-1, -1, K, -1)

    ein = expert_in[:, :, :cap].transpose(0, 1).reshape(E, -1, d)  # (E, G*C, D)
    eout = _experts_ffn(spec, params, ein)
    expert_out = eout.reshape(E, n_groups, cap, d).transpose(0, 1)  # (G,E,C,D)

    # combine: each token's kept choices, weighted by their renormalised
    # gates, summed over the choices in fp32
    w = gate_vals * keep.to(torch.float32)                  # (G, g, K)
    picked = expert_out[gsel, idx, slot.clamp(max=cap - 1)].to(torch.float32)
    yg = torch.sum(w[..., None] * picked, dim=2)            # (G, g, D)
    y = yg.reshape(-1, d)[:total].reshape(b, s, d).to(x.dtype)

    # load-balance aux loss (over the padded groups, as the reference)
    routed = torch.sum(expert_oh * keep[..., None], dim=2).reshape(-1, E)
    probs = probs.reshape(-1, E)
    if group is None:
        frac_tokens = torch.mean(routed, dim=0)
        frac_probs = torch.mean(probs, dim=0)
    else:
        from repro_torch.plan.sharded import sum_over_ranks

        rows = probs.new_full((1,), float(probs.shape[0]))
        sums = sum_over_ranks(torch.cat([torch.sum(routed, dim=0),
                                         torch.sum(probs, dim=0), rows]), group)
        frac_tokens, frac_probs = sums[:E] / sums[-1], sums[E:2 * E] / sums[-1]
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
