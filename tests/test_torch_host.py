"""Host primitives of the port vs the reference: arrays and bytes identical.

The port keeps its own copies of the reference's numpy-only modules (it
imports nothing of the reference package). Same seeded numpy inputs through
both; the gate is exact equality.
"""

import jax
import numpy as np
import pytest

from repro.core import blocking as r_blocking
from repro.core import container as r_container
from repro.core import entropy as r_entropy
from repro.core import index_coding as r_index
from repro.core import metrics as r_metrics
from repro.core import pca as r_pca
from repro.core import quantization as r_quant
from repro.data import s3d as r_s3d
from repro_torch.core import blocking as t_blocking
from repro_torch.core import container as t_container
from repro_torch.core import entropy as t_entropy
from repro_torch.core import index_coding as t_index
from repro_torch.core import metrics as t_metrics
from repro_torch.core import pca as t_pca
from repro_torch.core import quantization as t_quant
from repro_torch.data import s3d as t_s3d


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_blocking_roundtrip_identical():
    data = _rng(1).normal(size=(4, 8, 20, 20)).astype(np.float32)
    gr, gt = r_blocking.PAPER_GEOMETRY, t_blocking.PAPER_GEOMETRY
    assert (gr.bt, gr.ph, gr.pw) == (gt.bt, gt.ph, gt.pw) == (4, 5, 4)
    br, bt_ = r_blocking.to_blocks(data, gr), t_blocking.to_blocks(data, gt)
    np.testing.assert_array_equal(br, bt_)
    assert bt_.shape == (40, 4, 4, 5, 4)
    vr, vt = r_blocking.blocks_as_vectors(br), t_blocking.blocks_as_vectors(bt_)
    np.testing.assert_array_equal(vr, vt)
    np.testing.assert_array_equal(
        t_blocking.from_blocks(t_blocking.vectors_as_blocks(vt, gt),
                               data.shape, gt), data)
    with pytest.raises(ValueError):
        t_blocking.check_divisible((4, 7, 20, 20), gt)


def test_metrics_identical():
    x = _rng(2).normal(size=(6, 30, 30))
    y = x + 0.01 * _rng(3).normal(size=x.shape)
    assert t_metrics.nrmse(x, y) == r_metrics.nrmse(x, y)
    assert t_metrics.mean_nrmse(x, y) == r_metrics.mean_nrmse(x, y)
    assert t_metrics.psnr(x, y) == r_metrics.psnr(x, y)
    assert t_metrics.ssim2d(x[0], y[0]) == r_metrics.ssim2d(x[0], y[0])


@pytest.mark.parametrize("bin_size", [0.05, 1e-3])
def test_quantize_dequantize_identical(bin_size):
    x = _rng(4).normal(size=(100, 36))
    qr, qt = r_quant.quantize(x, bin_size), t_quant.quantize(x, bin_size)
    np.testing.assert_array_equal(qr, qt)
    np.testing.assert_array_equal(r_quant.dequantize(qr, bin_size),
                                  t_quant.dequantize(qt, bin_size))
    with pytest.raises(ValueError):
        t_quant.quantize(x, 0.0)


@pytest.mark.parametrize("nbytes", [2, 4])
def test_quantize_params_matches_reference(nbytes):
    tree = {"a": {"w": _rng(5).normal(size=(7, 3)).astype(np.float32),
                  "b": np.zeros(3, np.float32)},
            "z": {"w": (1e-3 * _rng(6).normal(size=(3, 3, 3, 2, 4))
                        ).astype(np.float32)}}
    want = r_quant.quantize_params(tree, nbytes)
    got = t_quant.quantize_params(tree, nbytes)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert b.dtype == np.float32
    with pytest.raises(ValueError):
        t_quant.param_storage_dtype(3)


def test_pca_basis_stack_identical():
    r = _rng(7).normal(size=(3, 120, 20))
    br, er = r_pca.pca_basis_stack(r)
    bt_, et = t_pca.pca_basis_stack(r)
    np.testing.assert_array_equal(br, bt_)
    np.testing.assert_array_equal(er, et)
    np.testing.assert_array_equal(r_pca.pca_basis(r[0])[0],
                                  t_pca.pca_basis(r[0])[0])


def test_index_coding_bytes_identical():
    rng = _rng(8)
    sets = [np.sort(rng.choice(80, size=rng.integers(0, 12), replace=False))
            for _ in range(200)]
    off_r, flat_r = r_index.sets_to_csr(sets)
    off_t, flat_t = t_index.sets_to_csr(sets)
    np.testing.assert_array_equal(off_r, off_t)
    np.testing.assert_array_equal(flat_r, flat_t)
    blob_r = r_index.encode_indices(off_r, flat_r)
    blob_t = t_index.encode_indices(off_t, flat_t)
    assert blob_r == blob_t
    assert t_index.encoded_size_bytes(off_t, flat_t) == len(blob_r)
    off_d, flat_d = t_index.decode_indices(blob_r)
    np.testing.assert_array_equal(off_d, off_r)
    np.testing.assert_array_equal(flat_d, flat_r)


@pytest.mark.parametrize("seed,scale", [(0, 3.0), (1, 40.0), (2, 0.2)])
def test_huffman_encode_decode_identical(seed, scale):
    vals = np.rint(_rng(seed).normal(scale=scale, size=5000)).astype(np.int64)
    blob_r, blob_t = r_entropy.huffman_encode(vals), t_entropy.huffman_encode(vals)
    assert blob_r == blob_t
    assert t_entropy.huffman_size_bytes(vals) == len(blob_r)
    np.testing.assert_array_equal(t_entropy.huffman_decode(blob_r), vals)
    np.testing.assert_array_equal(t_entropy.huffman_decode_ref(blob_r), vals)
    np.testing.assert_array_equal(r_entropy.huffman_decode(blob_t), vals)


def test_huffman_segmented_payloads_identical():
    vals = np.rint(_rng(9).normal(scale=5.0, size=(64, 36))).astype(np.int64)
    sym_r, len_r = r_entropy.huffman_codebook(vals)
    sym_t, len_t = t_entropy.huffman_codebook(vals)
    np.testing.assert_array_equal(sym_r, sym_t)
    np.testing.assert_array_equal(len_r, len_t)
    parts = [vals[:20], vals[20:]]
    sp, lp = t_entropy.huffman_codebook_parts(parts)
    np.testing.assert_array_equal(sp, sym_r)
    np.testing.assert_array_equal(lp, len_r)
    pay_r = [r_entropy.huffman_payload(p, sym_r, len_r) for p in parts]
    pay_t = [t_entropy.huffman_payload(p, sym_t, len_t) for p in parts]
    assert pay_r == pay_t
    outs = t_entropy.huffman_decode_payloads(
        pay_t, [p.size for p in parts], sym_t, len_t)
    for out, p in zip(outs, parts):
        np.testing.assert_array_equal(out, p.reshape(-1))


def test_huffman_decode_many_identical():
    streams = [np.rint(_rng(20 + i).normal(scale=4.0, size=300 + 50 * i)
                       ).astype(np.int64) for i in range(4)]
    blobs = [t_entropy.huffman_encode(v) for v in streams]
    for got, want in zip(t_entropy.huffman_decode_many(blobs), streams):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(r_entropy.huffman_decode_many(blobs), streams):
        np.testing.assert_array_equal(got, want)


def test_huffman_truncated_input_raises():
    vals = np.rint(_rng(10).normal(scale=3.0, size=2000)).astype(np.int64)
    blob = t_entropy.huffman_encode(vals)
    with pytest.raises(ValueError):
        t_entropy.huffman_decode(blob[: len(blob) - 40])
    with pytest.raises(Exception):
        t_entropy.huffman_decode(blob[:6])


def test_container_bytes_identical_and_typed_errors():
    streams = [("meta", b"abc"), ("latent", bytes(range(200))), ("x", b"")]
    wr, wt = r_container.ContainerWriter(version=5), t_container.ContainerWriter(version=5)
    for name, payload in streams:
        wr.add(name, payload)
        wt.add(name, payload)
    blob = wt.to_bytes()
    assert blob == wr.to_bytes()
    assert (t_container.pack_header(5, [(n, len(p)) for n, p in streams])
            == r_container.pack_header(5, [(n, len(p)) for n, p in streams]))
    rd = t_container.ContainerReader(blob)
    assert rd.version == 5 and rd.names == [n for n, _ in streams]
    assert rd["latent"] == bytes(range(200))
    assert rd.stream_sizes() == r_container.ContainerReader(blob).stream_sizes()
    with pytest.raises(t_container.ContainerFormatError):
        t_container.ContainerReader(blob[:-10])
    with pytest.raises(t_container.ContainerFormatError):
        t_container.ContainerReader(b"NOPE" + blob[4:])
    assert issubclass(t_container.ContainerFormatError, ValueError)


def test_s3d_generate_identical():
    kw = dict(n_species=4, n_time=8, height=20, width=20, seed=3)
    a = r_s3d.generate(r_s3d.S3DConfig(**kw))
    b = t_s3d.generate(t_s3d.S3DConfig(**kw))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    win = t_s3d.generate_species_window(t_s3d.S3DConfig(**kw), 4, 8)
    np.testing.assert_array_equal(win, a["species"][:, 4:8])
