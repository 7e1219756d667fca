"""Port vs reference: the analytic roofline terms.

``repro_torch.roofline`` is the reference's arithmetic over ``ArchConfig``
and ``ShapeSpec``: every function equals the reference's exactly, over
every arch of the registry and every shape of ``SHAPES``, at the
production meshes' sizes; its constants are the H100's, not the TPU's.
"""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.models.config import SHAPES as JAX_SHAPES
from repro.roofline import analytic as JA
from repro_torch import roofline as R
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.config import SHAPES
from repro_torch.roofline import analytic as A

#: the reference's production meshes (``roofline_for_cell``)
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_count_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    assert A.ctx_enc(cfg) == JA.ctx_enc(jcfg)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert A.fwd_flops(cfg, shape) == JA.fwd_flops(jcfg, jshape)
        for remat in (True, False):
            assert A.step_flops(cfg, shape, remat=remat) == \
                JA.step_flops(jcfg, jshape, remat=remat)
        assert A._cache_bytes(cfg, shape) == JA._cache_bytes(jcfg, jshape)
        for mesh in MESHES:
            n_dev = 1
            for v in mesh.values():
                n_dev *= v
            for n in (1, n_dev):
                assert A.analytic_hbm_bytes(cfg, shape, n) == \
                    JA.analytic_hbm_bytes(jcfg, jshape, n)
            assert A.analytic_collective_bytes(cfg, shape, mesh) == \
                JA.analytic_collective_bytes(jcfg, jshape, mesh)


def test_step_flops_is_four_forwards_in_training():
    cfg = get_config("stablelm-1.6b")
    shape = next(s for s in SHAPES.values() if s.kind == "train")
    f = A.fwd_flops(cfg, shape)
    assert A.step_flops(cfg, shape) == 4.0 * f
    assert A.step_flops(cfg, shape, remat=False) == 3.0 * f
    assert f > 0


def test_roofline_terms_match_the_reference():
    kw = dict(arch="a", shape="s", mesh="single", n_devices=256,
              compute_s=2.0, memory_s=3.0, collective_s=0.5,
              model_flops=6.0, analytic_flops=8.0, hlo_flops_per_dev=1.0,
              peak_bytes=7)
    for over in ({}, {"compute_s": 4.0}, {"collective_s": 9.0}):
        args = {**kw, **over}
        t, jt = A.RooflineTerms(**args), JA.RooflineTerms(**args)
        for prop in ("dominant", "total_s", "useful_ratio",
                     "roofline_fraction"):
            assert getattr(t, prop) == getattr(jt, prop)
    assert [f.name for f in dataclasses.fields(A.RooflineTerms)] == \
        [f.name for f in dataclasses.fields(JA.RooflineTerms)]


def test_constants_are_the_h100s():
    """NVIDIA H100 SXM5 data sheet: fp32 on the CUDA cores, bf16 on the
    tensor cores (dense), HBM3, NVLink one way; none is the reference's
    TPU v5e figure."""
    assert (R.PEAK_FLOPS, R.PEAK_FLOPS_BF16, R.HBM_BW, R.NVLINK_BW) == \
        (67e12, 989e12, 3.35e12, 450e9)
    assert JA.PEAK_FLOPS not in (R.PEAK_FLOPS, R.PEAK_FLOPS_BF16)
    assert R.HBM_BW != JA.HBM_BW
    assert R.NVLINK_BW != JA.ICI_BW
    assert not hasattr(A, "ICI_BW")
    # the mesh assembly is ported with the dry run; its collective term
    # runs at NVLINK_BW (tests/test_torch_dryrun.py holds it to the
    # reference's)
    assert R.roofline_for_cell is A.roofline_for_cell
