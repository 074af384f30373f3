"""The dry run's depth extrapolation against a direct full-depth count
for the families whose depth is two numbers, on the CPU (port-only; the
one-stack families are in ``test_torch_dryrun_depth.py``): the
encoder-decoder's encoder and decoder layers, and the hybrid's layers and
shared-attention groups.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from test_torch_dryrun_depth import FAMILIES, TRAIN, count, extrapolated, variant_base


def test_encdec_extrapolated_flops_equal_a_full_depth_count():
    """Encoder and decoder layers are each a homogeneous stack: the
    variants solve for both exactly."""
    cfg = get_config(FAMILIES["encdec"], smoke=True).with_(
        n_layers=3, encoder_layers=3)
    direct = count(cfg.with_(**variant_base(cfg, TRAIN)))
    assert direct > 0
    assert extrapolated(cfg) == direct


def test_hybrid_extrapolation_counts_one_shared_attention():
    """The reference's hybrid variants carry the shared attention once
    (``attn_every=0`` is one group of every layer), so the extrapolation
    counts one shared attention where the model applies it once a group:
    it falls short of the full-depth count by ``n_groups - 1`` of them,
    measured here as the difference of two full-depth counts.  With
    ``remat="none"``: under remat a layer inside a group is recomputed
    once more than one in the tail."""
    cfg = get_config(FAMILIES["hybrid"], smoke=True).with_(remat="none")
    n_groups = cfg.n_layers // cfg.attn_every
    assert n_groups > 1
    base = variant_base(cfg, TRAIN)
    direct = count(cfg.with_(**base))
    g = cfg.attn_every
    # 2 groups of g layers against 1 group of the same 2g layers
    attn = (count(cfg.with_(n_layers=2 * g, **base))
            - count(cfg.with_(n_layers=2 * g, attn_every=0, **base)))
    assert attn > 0
    assert extrapolated(cfg) + (n_groups - 1) * attn == direct
