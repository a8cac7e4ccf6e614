"""The port's container codec vs the reference's: the wire contract.

* the same artifact (same numpy arrays in both packages' classes) encodes
  to **byte-identical** v5 blobs, fp32 and fp16 parameters, and to
  byte-identical v1-v4 blobs;
* a blob the reference wrote decodes under the port within
  ``bound * (1 + 1e-3)`` (the reference's own slack: the decoder network
  runs on another backend, so ``x_rec`` drifts by fp32 ulps from the one
  the guarantee was computed against), and the reverse;
* a reference-written v1-v4 blob decodes under the port bitwise equal to
  the port's decode of the reference's v5 blob of the same artifact, and
  the port's staged ``decompress_reference`` is bitwise its
  ``decompress``.

Fits are tiny (S=4, T=8, 20x20 -> 40 blocks, conv (8,16), <= 10 steps).
"""

import jax
import numpy as np
import pytest
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro import codec as r_codec
from repro.core import gae as r_gae
from repro.core import metrics
from repro.core.pipeline import PipelineConfig as RefConfig
from repro.data import s3d
from repro_torch import codec as t_codec
from repro_torch.codec import format as t_wire
from repro_torch.core import blocking as t_blocking
from repro_torch.core import gae as t_gae
from repro_torch.core.container import ContainerFormatError, ContainerReader
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig

S, T, H, W = 4, 8, 20, 20
NB = (T // 4) * (H // 5) * (W // 4)
KW = dict(latent=8, conv_channels=(8, 16), ae_steps=10, corr_steps=8,
          batch_size=16)
TARGET = 1e-2


@pytest.fixture(scope="module")
def data():
    return s3d.generate(s3d.S3DConfig(
        n_species=S, n_time=T, height=H, width=W, seed=3))["species"]


@pytest.fixture(scope="module")
def reference_blob(reference_x64, data):  # noqa: F811
    gb = r_codec.GBATCCodec(RefConfig(**KW))
    return gb.compress_report(data, target_nrmse=TARGET)


@pytest.fixture(scope="module")
def port_blob(data):
    gb = GBATCCodec(PipelineConfig(**KW), device="cpu")
    return gb.compress_report(data, target_nrmse=TARGET)


def _artifact_fields(param_dtype_bytes, with_corr):
    """One artifact's worth of numpy data, independent of either package's
    fit: reference-initialised parameter trees, random quantised latents,
    and guarantee artifacts from the (oracle-identical) port engine."""
    from repro.core import autoencoder as r_ae
    from repro.core import correction as r_corr

    rng = np.random.default_rng(11)
    model = r_ae.BlockAutoencoder(r_ae.AEConfig(
        n_species=S, block=(4, 5, 4), latent=8, conv_channels=(8, 16)))
    ae = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(5)))
    corr = None
    if with_corr:
        net = r_corr.TensorCorrectionNetwork(r_corr.CorrectionConfig(n_species=S))
        corr = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(6)))
    x = rng.normal(size=(S, NB, 80)).astype(np.float32)
    x_rec = (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    _, arts = t_gae.guarantee_batched(x, x_rec, 0.3, device="cpu")
    return dict(
        latent_q=np.rint(rng.normal(scale=6.0, size=(NB, 8))).astype(np.int64),
        latent_bin=0.0125, ae_params=ae, corr_params=corr,
        norm_min=rng.normal(size=S).astype(np.float32),
        norm_range=rng.uniform(0.5, 2.0, size=S).astype(np.float32),
        shape=(S, T, H, W),
    ), arts, param_dtype_bytes


@pytest.mark.parametrize("param_dtype_bytes,with_corr",
                         [(4, True), (2, True), (4, False)])
def test_same_artifact_same_bytes(param_dtype_bytes, with_corr):
    fields, arts, pdb = _artifact_fields(param_dtype_bytes, with_corr)
    kw = dict(KW, use_correction=with_corr, param_dtype_bytes=pdb)
    ref_arts = [r_gae.GuaranteeArtifact(
        basis=a.basis, coeff_q=a.coeff_q, index_offsets=a.index_offsets,
        index_flat=a.index_flat, coeff_bin=a.coeff_bin, tau=a.tau) for a in arts]
    ref_blob = r_codec.encode(r_codec.CompressedArtifact(
        species_guarantees=ref_arts, cfg=RefConfig(**kw), **fields))
    blob = t_codec.encode(t_codec.CompressedArtifact(
        species_guarantees=arts, cfg=PipelineConfig(**kw), **fields))
    assert blob == ref_blob
    assert ContainerReader(blob).version == 5
    assert t_codec.stream_breakdown(blob) == r_codec.stream_breakdown(ref_blob)
    assert t_codec.stream_breakdown(blob)["total"] == len(blob)


def test_decode_artifact_recovers_streams():
    fields, arts, _ = _artifact_fields(4, True)
    blob = t_codec.encode(t_codec.CompressedArtifact(
        species_guarantees=arts, cfg=PipelineConfig(**KW), **fields))
    back = t_codec.decode_artifact(blob, device="cpu")
    np.testing.assert_array_equal(back.latent_q, fields["latent_q"])
    assert back.latent_bin == fields["latent_bin"] and back.shape == fields["shape"]
    for layer, leaves in back.ae_params.items():
        assert layer.startswith("dec")
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(value, fields["ae_params"][layer][leaf])
    for layer, leaves in back.corr_params.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(value, fields["corr_params"][layer][leaf])
    for a, b in zip(back.species_guarantees, arts):
        np.testing.assert_array_equal(a.coeff_q, b.coeff_q)
        np.testing.assert_array_equal(a.index_flat, b.index_flat)
        np.testing.assert_array_equal(a.basis, b.basis)
    assert t_codec.encode(back) == blob


def test_reference_blob_decodes_in_port(reference_blob, data):
    blob, rep = reference_blob
    field = t_codec.decompress(blob, device="cpu")
    assert field.shape == data.shape and field.dtype == np.float32
    nrmse = np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])
    # the worst per-species excess over the target (negative: none), shown
    # with ``pytest -s``
    print(f"conv, reference blob decoded by the port: max NRMSE "
          f"{float(nrmse.max())!r}, excess over the target "
          f"{nrmse.max() / TARGET - 1:+.3e}, largest change from the "
          f"reference's own decode {np.abs(nrmse - rep.per_species_nrmse).max():.3e}")
    assert (nrmse <= TARGET * (1 + 1e-3)).all(), nrmse
    # and close to what the reference itself reconstructs from it
    np.testing.assert_allclose(field, rep.recon, rtol=0,
                               atol=1e-4 * np.abs(rep.recon).max())


def test_port_blob_decodes_in_reference(reference_x64, port_blob, data):  # noqa: F811
    blob, rep = port_blob
    field = r_codec.decompress(blob)
    nrmse = np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])
    assert (nrmse <= TARGET * (1 + 1e-3)).all(), nrmse
    np.testing.assert_allclose(field, rep.recon, rtol=0,
                               atol=1e-4 * np.abs(rep.recon).max())


def test_port_and_reference_blobs_share_stream_tables(reference_blob, port_blob):
    a, b = ContainerReader(reference_blob[0]), ContainerReader(port_blob[0])
    assert a.version == b.version == 5
    assert a.names == b.names
    assert len(a["decoder"]) == len(b["decoder"])
    assert len(a["correction"]) == len(b["correction"])
    meta_a = t_wire._unpack_meta(a["meta"], version=5)
    meta_b = t_wire._unpack_meta(b["meta"], version=5)
    assert meta_a[0] == meta_b[0] and meta_a[1] == meta_b[1]
    np.testing.assert_array_equal(meta_a[3], meta_b[3])  # normalisation min
    np.testing.assert_array_equal(meta_a[4], meta_b[4])  # normalisation range


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_older_versions_round_trip(reference_blob, data, version):
    blob, rep = reference_blob
    old = r_codec.encode(rep.artifact, version=version)
    # the port's writer: byte for byte the reference's, on the same artifact
    # (rebuilt by the port from the reference's v5 bytes)
    port_art = t_codec.decode_artifact(blob, device="cpu")
    assert t_codec.encode(port_art, version=version) == old
    assert ContainerReader(old).version == version
    # the reference's v-blob reads under the port as its v5 blob does
    field = t_codec.decompress(old, device="cpu")
    v5 = t_codec.decompress(blob, device="cpu")
    assert field.tobytes() == v5.tobytes()
    nrmse = np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])
    assert (nrmse <= TARGET * (1 + 1e-3)).all(), nrmse
    # the staged orchestration is the fused path's bit-identity oracle
    assert t_codec.decompress_reference(old, device="cpu").tobytes() \
        == field.tobytes()


def test_corrupt_blob_raises_and_evicts(port_blob):
    blob, _ = port_blob
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(ContainerFormatError):
        t_codec.decompress(bytes(bad), device="cpu")
    with pytest.raises(ContainerFormatError):
        t_codec.decompress(blob[:-7], device="cpu")
    # the clean blob still decodes, and repeat decodes hit the head cache
    t_codec.clear_decode_cache()
    a = t_codec.decompress(blob, device="cpu")
    hits = t_codec.cache_stats()["head"]["hits"]
    b = t_codec.decompress(blob, device="cpu")
    assert t_codec.cache_stats()["head"]["hits"] == hits + 1
    np.testing.assert_array_equal(a, b)


def test_invalid_on_error_is_refused(port_blob):
    blob, _ = port_blob
    with pytest.raises(ValueError, match="on_error"):
        t_codec.decompress(blob, on_error="ignore", device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        t_codec.PartialDecoder(blob, device="cpu").decode(on_error="ignore")


def test_blocking_geometry_on_the_wire_is_the_papers(port_blob):
    cfg = t_wire._unpack_meta(ContainerReader(port_blob[0])["meta"], version=5)[0]
    assert cfg.geometry == t_blocking.PAPER_GEOMETRY
    assert cfg.family == "conv" and cfg.arch == (8, 16) and cfg.latent == 8
