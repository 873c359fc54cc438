"""Host-side copies: the port's configs and block patterns equal the JAX
package's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import patterns as JP
from repro_torch import configs as TC
from repro_torch.core import patterns as TP
from repro_torch.core.types import AttentionSpec as TSpec
from test_kernels import SPEC_CASES

torch.set_num_threads(1)


def _tspec(spec):
    return TSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("spec", SPEC_CASES, ids=str)
@pytest.mark.parametrize("shape", [(256, 256, 64, 64), (200, 200, 64, 32),
                                   (16, 256, 64, 64)])
def test_block_patterns_equal(spec, shape):
    lq, lkv, bq, bk = shape
    want = JP.build_block_pattern(spec, lq, lkv, bq, bk)
    got = TP.build_block_pattern(_tspec(spec), lq, lkv, bq, bk)
    np.testing.assert_array_equal(got.kv_block_map, want.kv_block_map)
    np.testing.assert_array_equal(got.slot_kinds, want.slot_kinds)
    np.testing.assert_array_equal(got.inverse().q_block_map,
                                  want.inverse().q_block_map)
    np.testing.assert_array_equal(got.inverse().slot_kinds,
                                  want.inverse().slot_kinds)
    np.testing.assert_array_equal(TP.dense_mask(_tspec(spec), lq, lkv),
                                  JP.dense_mask(spec, lq, lkv))
    np.testing.assert_array_equal(TP.random_blocks_mask(got),
                                  JP.random_blocks_mask(want))


@pytest.mark.parametrize("arch", JC.ARCH_IDS + JC.PAPER_IDS)
def test_configs_equal(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(JC, get)(arch)
        got = getattr(TC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    want = JC.with_swat(JC.reduce_config(JC.get_config(arch)), 64, 4)
    got = TC.with_swat(TC.reduce_config(TC.get_config(arch)), 64, 4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
