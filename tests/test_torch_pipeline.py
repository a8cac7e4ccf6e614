"""The slice as a whole, on the CPU: fit -> compress -> bytes -> decompress.

Small size (S=4, T=8, 20x20 -> 40 blocks, conv (8,16), a few dozen steps),
``device="cpu"`` throughout, so the kernels' plain versions run. The gates
are the system's own: the per-species NRMSE bound (the guarantee is
enforced per block, so it holds with no slack on the encode side's own
reconstruction), ``decompress(blob)`` bitwise equal to the report's
reconstruction, exact byte accounting, and prepared-state reuse.
"""

import numpy as np
import pytest
import torch

from repro_torch import codec
from repro_torch.core import metrics
from repro_torch.core.pipeline import (
    CompressionReport,
    GBATCCodec,
    GBATCPipeline,
    PipelineConfig,
)
from repro_torch.data import s3d
from repro_torch.kernels import gbatc_project as cuda_wrappers

S = 4
KW = dict(latent=8, conv_channels=(8, 16), ae_steps=30, corr_steps=20,
          batch_size=16)


@pytest.fixture(scope="module")
def data():
    return s3d.generate(s3d.S3DConfig(
        n_species=S, n_time=8, height=20, width=20, seed=0))["species"]


@pytest.fixture(scope="module")
def fitted(data):
    return GBATCCodec(PipelineConfig(**KW), device="cpu").fit(data)


def _nrmse(data, field):
    return np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])


@pytest.mark.parametrize("target", [1e-2, 1e-3])
def test_bound_met_and_decode_is_bitwise(fitted, data, target):
    blob, rep = fitted.compress_report(target_nrmse=target)
    assert isinstance(rep, CompressionReport) and isinstance(blob, bytes)
    assert (rep.per_species_nrmse <= target).all()
    field = codec.decompress(blob, device="cpu")
    assert field.shape == data.shape and field.dtype == np.float32
    assert np.isfinite(field).all()
    assert (_nrmse(data, field) <= target * (1 + 1e-3)).all()
    np.testing.assert_array_equal(field, rep.recon)
    assert len(blob) == rep.bytes_breakdown["total"]
    assert rep.compression_ratio == pytest.approx(data.nbytes / len(blob))


def test_one_shot_compress_fits_first(data):
    gb = GBATCCodec(PipelineConfig(**dict(KW, ae_steps=5, corr_steps=5)),
                    device="cpu")
    assert not gb.fitted
    with pytest.raises(RuntimeError, match="not fitted"):
        gb.compress()
    blob = gb.compress(data, target_nrmse=1e-2)
    assert gb.fitted
    assert (_nrmse(data, gb.decompress(blob)) <= 1e-2 * (1 + 1e-3)).all()
    with pytest.raises(ValueError, match="expected"):
        gb.fit(data[0])


def test_prepared_state_is_reused_across_bounds(fitted):
    pipe = fitted.pipeline
    pipe.compress(target_nrmse=1e-2)
    calls = []
    real = pipe._gengine.prepare
    pipe._gengine.prepare = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        pipe.compress(target_nrmse=1e-3)
        pipe.compress(target_nrmse=3e-3)
    finally:
        del pipe._gengine.prepare
    assert calls == []
    assert len(pipe._prepared) == 1


def test_tighter_bound_costs_more_bytes(fitted):
    loose = fitted.compress(target_nrmse=1e-2)
    tight = fitted.compress(target_nrmse=1e-3)
    assert len(tight) > len(loose)


def test_gba_variant_reports_no_correction_bytes(fitted, data):
    blob, rep = fitted.compress_report(target_nrmse=1e-2, skip_correction=True)
    assert rep.bytes_breakdown["correction"] == 0
    assert rep.artifact.corr_params is None
    field = codec.decompress(blob, device="cpu")
    np.testing.assert_array_equal(field, rep.recon)
    assert (_nrmse(data, field) <= 1e-2 * (1 + 1e-3)).all()
    # GBATC and GBA share the encoder: two prepared states now
    assert len(fitted.pipeline._prepared) == 2


def test_fp16_params_meet_the_bound(data):
    gb = GBATCCodec(PipelineConfig(**dict(KW, param_dtype_bytes=2)), device="cpu")
    blob, rep = gb.compress_report(data, target_nrmse=1e-2)
    full, _ = GBATCCodec(PipelineConfig(**KW), device="cpu").compress_report(
        data, target_nrmse=1e-2)
    dec16 = codec.stream_breakdown(blob)["decoder"]
    assert dec16 * 2 == codec.stream_breakdown(full)["decoder"]
    field = codec.decompress(blob, device="cpu")
    np.testing.assert_array_equal(field, rep.recon)
    assert (_nrmse(data, field) <= 1e-2 * (1 + 1e-3)).all()


def test_pipeline_decompress_checks_structure(fitted, data):
    rep = fitted.pipeline.compress(target_nrmse=1e-2)
    np.testing.assert_array_equal(fitted.pipeline.decompress(rep.artifact),
                                  rep.recon)
    other = GBATCPipeline(PipelineConfig(**dict(KW, latent=12)), n_species=S,
                          device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.decompress(rep.artifact)
    with pytest.raises(RuntimeError, match="fit"):
        other.compress()


def test_cpu_run_launches_no_cuda_kernel_and_records_timings(fitted):
    fitted.compress(target_nrmse=1e-2)
    assert set(cuda_wrappers.launch_counts().values()) == {0}
    t = fitted.pipeline.timings
    assert {"fit_ae", "fit_correction", "prepare", "select", "encode"} <= set(t)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GBATCCodec(PipelineConfig(**KW))
    with pytest.raises(RuntimeError, match="CUDA"):
        GBATCPipeline(PipelineConfig(**KW), n_species=S)
