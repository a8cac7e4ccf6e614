"""The kernels' widened domains against the JAX package, on the CPU.

The CUDA kernels take every head dim D >= 1 (flash attention: past D = 256
on ``flash_wide``), every RWKV-6 head size N >= 1 (``rwkv6_scan``: past N =
64 in 64-column slabs, past 256 with S in device memory) and every grid
past 65,535 in y; the card's checks of those routes are in
``chip_smoke.py``. Here, with ``device="cpu"`` (each kernel's plain
version), at small sizes:

* flash's plain version against the reference's Pallas kernel in
  interpret mode at D = 257, 320 and 512 (causal, windowed, and non-causal
  at Tk a multiple of ``block_k``, ROADMAP C-ref-2): fp32 to 2e-5, bf16 to
  the reference's 2e-2;
* ``rwkv6_scan_ref`` against the reference's Pallas kernel at N = 65, 96
  and 128, with and without s0, to 2e-4;
* the attention codec at arch (512, 1, 1, 1024), one 512-wide head: the
  port's compress -> ``decompress(bytes)`` meets the bound, a blob the JAX
  package writes decodes in the port within ``bound * (1 + 1e-3)`` and the
  port's blob decodes in the JAX package, and the guarantee artifacts of
  the port's engine equal the reference engine's bit for bit on the port
  codec's own (x, x_rec).

RWKV-6 with 128-wide heads is in ``test_torch_wide_lm.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gae import (_assert_same_artifact, reference_pallas_load,  # noqa: F401
                            reference_x64)

from repro import codec as r_codec
from repro.core import gae as r_gae
from repro.core.pipeline import PipelineConfig as RefConfig
from repro.data import s3d
from repro.kernels import flash_attention as r_flash
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro_torch import codec as t_codec
from repro_torch.core import gae as t_gae
from repro_torch.core import metrics
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.core.quantization import dequantize
from repro_torch.kernels import ref


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is many small ops. On one thread they run
    without waiting for the threads of the other pytest workers that share
    the cores (at eight threads under six workers the wide-head codec's fit
    took 19 times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- flash attention past D = 256 --------------------------------------------
# (b, h, tq, tk, d, causal, window, block_q, block_k)
FLASH_WIDE = [(1, 2, 96, 96, 257, True, 0, 32, 32),
              (1, 1, 128, 128, 320, True, 40, 64, 64),
              (2, 1, 64, 128, 512, False, 0, 64, 64),
              (1, 1, 64, 64, 512, True, 16, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_WIDE)
def test_flash_ref_matches_pallas_past_d256(reference_pallas_load, case, dtype):  # noqa: F811
    b, h, tq, tk, d, causal, window, bq, bk = case
    rng = np.random.default_rng(d + window)
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = r_flash.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, tq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -- rwkv6_scan past N = 64 ---------------------------------------------------
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("b,t,h,n,chunk", [(1, 40, 2, 65, 8), (2, 24, 1, 96, 8),
                                           (1, 32, 1, 128, 16)])
def test_rwkv6_ref_matches_pallas_past_n64(reference_pallas_load, b, t, h, n, chunk,  # noqa: F811
                                          with_s0):
    rng = np.random.default_rng(n + t)
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(3))
    w = np.clip(1 / (1 + np.exp(-3 * rng.normal(size=(b, t, h, n)))), 1e-6, 1 - 1e-6)
    u = 0.5 * rng.normal(size=(h, n))
    args = [r, k, v, w.astype(np.float32), u.astype(np.float32)]
    if with_s0:
        args.append(rng.normal(size=(b, h, n, n)).astype(np.float32))
    want, want_state = pallas_rwkv6_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                                         interpret=True)
    got, state = ref.rwkv6_scan_ref(*(torch.from_numpy(a) for a in args))
    for g, w_ in ((got, want), (state, want_state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=2e-4, atol=2e-4)


# -- the attention codec with one 512-wide head ------------------------------
S, ARCH, BOUND = 4, (512, 1, 1, 1024), 1e-2
PIPE_KW = dict(family="attention", arch=ARCH, latent=8, ae_steps=8, corr_steps=2, seed=0)


@pytest.fixture(scope="module")
def data():
    return s3d.generate(s3d.S3DConfig(
        n_species=S, n_time=8, height=20, width=16, seed=11))["species"]


@pytest.fixture(scope="module")
def port_codec(data):
    gb = GBATCCodec(PipelineConfig(**PIPE_KW), device="cpu")
    blob, rep = gb.compress_report(data, target_nrmse=BOUND)
    return gb, blob, rep


@pytest.fixture(scope="module")
def reference_report(reference_x64, data):  # noqa: F811
    return r_codec.GBATCCodec(RefConfig(**PIPE_KW)).compress_report(data, target_nrmse=BOUND)


def _nrmse(data, field):
    return np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])


def test_wide_head_port_blob_meets_bound(port_codec, data):
    _, blob, rep = port_codec
    field = t_codec.decompress(blob, device="cpu")
    np.testing.assert_array_equal(field, rep.recon)
    assert (_nrmse(data, field) <= BOUND * (1 + 1e-3)).all()


def test_wide_head_blobs_cross_the_packages(reference_x64, port_codec,  # noqa: F811
                                           reference_report, data):
    blob, rep = reference_report
    field = t_codec.decompress(blob, device="cpu")
    assert field.shape == data.shape and field.dtype == np.float32
    assert (_nrmse(data, field) <= BOUND * (1 + 1e-3)).all()
    np.testing.assert_allclose(field, rep.recon, rtol=0, atol=1e-4 * np.abs(rep.recon).max())
    _, port_blob, port_rep = port_codec
    field = r_codec.decompress(port_blob)
    assert (_nrmse(data, field) <= BOUND * (1 + 1e-3)).all()
    np.testing.assert_allclose(field, port_rep.recon, rtol=0,
                               atol=1e-4 * np.abs(port_rep.recon).max())


def test_wide_head_guarantee_artifacts_equal_reference_engine(reference_x64,  # noqa: F811
                                                             port_codec):
    gb, _, _ = port_codec
    pipe = gb.pipeline
    (_, lat_q, lat_bin, corr, _), = pipe._prepared.values()
    x = pipe._orig_vectors()
    x_rec = pipe._decode_vecs(pipe._ae_params, dequantize(lat_q, lat_bin), corr)
    tau = BOUND * np.sqrt(x.shape[2])  # the pipeline's, on [0, 1] data
    ref_c, ref_arts = r_gae.GuaranteeEngine().select(
        r_gae.GuaranteeEngine().prepare(x, x_rec), tau)
    eng = t_gae.GuaranteeEngine("cpu")
    c, arts = eng.select(eng.prepare(x, x_rec), tau)
    for a, b in zip(arts, ref_arts, strict=True):
        _assert_same_artifact(a, b)
    np.testing.assert_allclose(c, ref_c, atol=1e-6)
