"""The ten other architectures in the port's DSE, against the reference.

``repro_torch.configs`` holds copies of the reference's config modules,
and ``dse_cli._block_specs`` enumerates every family's projections (moe
experts at their capacity share, the hybrid's shared attention, rwkv's
time and channel mix, the encoder-decoder's three stacks).  Everything
here is exact: configs as dataclass dicts, specs, per-layer networks and
the ``--smoke --top-k 2 --tokens 64`` report minus its wall-clock keys.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro import dse_cli as ref_dse_cli
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_shape_applicable
from repro_torch import dse_cli
from repro_torch.configs import ARCH_IDS, SHAPES, all_arch_ids, get_config, shape_applicable
from test_torch_dse_cli import _main, _strip

torch.set_num_threads(2)

ALL = ("tt-lm-100m",) + ARCH_IDS


def _spec_row(spec, count, scale) -> tuple:
    return (spec.name, spec.d_in, spec.d_out, spec.bias, spec.tag,
            spec.tensorized, spec.out_modes if spec.tensorized else None,
            spec.in_modes if spec.tensorized else None,
            spec.tt_ranks if spec.tensorized else None,
            dataclasses.asdict(spec.tt) if spec.tt is not None else None,
            count, scale)


def test_arch_ids_and_shapes_match_reference():
    assert ARCH_IDS == REF_ARCH_IDS == all_arch_ids()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL)
def test_config_matches_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert (cfg.is_causal_lm, cfg.supports_long_context, cfg.has_decode, cfg.hd) == \
        (rcfg.is_causal_lm, rcfg.supports_long_context, rcfg.has_decode, rcfg.hd)
    assert dataclasses.asdict(get_config(arch, tt=False, smoke=smoke)) == \
        dataclasses.asdict(ref_get_config(arch, tt=False, smoke=smoke))
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == ref_shape_applicable(rcfg, REF_SHAPES[name])


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL)
def test_block_specs_match_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
    assert [_spec_row(*r) for r in dse_cli._block_specs(cfg)] == \
        [_spec_row(*r) for r in ref_dse_cli._block_specs(rcfg)]


@pytest.mark.parametrize("arch", ALL)
def test_model_dse_layers_match_reference(arch):
    mine = dse_cli.model_dse_layers(get_config(arch, smoke=True), tokens=64)
    theirs = ref_dse_cli.model_dse_layers(ref_get_config(arch, smoke=True), tokens=64)
    assert [(n, [(x.name, x.edges, x.dims, x.kind) for x in tn.nodes])
            for n, tn in mine] == \
        [(n, [(x.name, x.edges, x.dims, x.kind) for x in tn.nodes])
         for n, tn in theirs]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_report_matches_reference(arch):
    argv = ["--arch", arch, "--smoke", "--top-k", "2", "--tokens", "64"]
    rc, out, err = _main(dse_cli.main, argv)
    rrc, rout, rerr = _main(ref_dse_cli.main, argv)
    assert rc == rrc == 0, err + rerr
    assert _strip(json.loads(out)) == _strip(json.loads(rout))


def test_unknown_arch_message_matches_reference():
    with pytest.raises(KeyError) as mine:
        dse_cli.dse_problems("nope")
    with pytest.raises(KeyError) as theirs:
        ref_dse_cli.dse_problems("nope")
    assert str(mine.value) == str(theirs.value)
