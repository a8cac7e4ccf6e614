"""The port's selective decode: random access by species / time window.

Mirrors the reference's ``tests/test_partial.py`` and the slice and shard
cases of ``tests/test_shards.py`` on the port (``device="cpu"``, the
kernels' plain versions):

* for ANY species subset and time window, ``decompress(blob, species=...,
  time_range=...)`` is **bitwise** the slice of the port's full decode,
  on every container version (v1-v5) and both encoder families;
* a window's rows run in the full decode's launch geometry, so even a
  one-row window (which a backend decodes in other bits when it runs at
  its own length) comes out bitwise the full decode's rows;
* a corrupt species or latent shard raises ``ContainerFormatError``
  naming it, without poisoning siblings;
* on the same reference-written blob the port and the reference agree on
  ``bytes_parsed``, ``latent_bytes_parsed`` and ``plan_slice``, and the
  port's selective decode is within ``bound * (1 + 1e-3)`` of the data
  (the cross-backend slack of ``tests/test_torch_codec.py``).

Fits are tiny (S=4, T=8, 20x20 -> 40 blocks, two time block-groups).
"""

import dataclasses

import numpy as np
import pytest
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro import codec as r_codec
from repro.codec import partial as r_partial
from repro.core.pipeline import PipelineConfig as RefConfig
from repro.data import s3d
from repro_torch import codec as t_codec
from repro_torch.codec import format as t_wire
from repro_torch.codec import partial as t_partial
from repro_torch.codec import runtime as t_runtime
from repro_torch.core import gae as t_gae
from repro_torch.core.container import (
    ContainerFormatError,
    ContainerReader,
    ContainerWriter,
)
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig

S, T, H, W = 4, 8, 20, 20
KW = dict(latent=8, conv_channels=(8, 16), ae_steps=10, corr_steps=8,
          batch_size=16)
TARGET = 1e-2
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data():
    return s3d.generate(s3d.S3DConfig(
        n_species=S, n_time=T, height=H, width=W, seed=3))["species"]


@pytest.fixture(scope="module")
def fitted(data):
    return GBATCCodec(PipelineConfig(**KW), **CPU).fit(data)


@pytest.fixture(scope="module")
def blob_and_report(fitted):
    return fitted.compress_report(target_nrmse=TARGET)


@pytest.fixture(scope="module")
def blob(blob_and_report):
    return blob_and_report[0]


@pytest.fixture(scope="module")
def full(blob):
    return t_codec.decompress(blob, **CPU)


@pytest.fixture(scope="module")
def reference_blob(reference_x64, data):  # noqa: F811
    return r_codec.GBATCCodec(RefConfig(**KW)).compress(
        data, target_nrmse=TARGET)


def _sliced(full, species, time_range):
    t0, t1 = time_range if time_range is not None else (0, full.shape[1])
    if species is None:
        out = full[:, t0:t1]
    elif isinstance(species, int):
        out = full[species, t0:t1]
    else:
        out = full[list(species)][:, t0:t1]
    return np.ascontiguousarray(out)


def _truncate_species_coeff(payload: bytes, sidx: int, keep: int) -> bytes:
    """Rebuild a combined (v2+) guarantee stream with species ``sidx``'s
    coeff payload cut to ``keep`` bytes, directory record updated to match
    — the framing stays valid, only that one stream is corrupt."""
    head, rec = t_wire._GDIR_HEAD, t_wire._GDIR_REC
    (s,) = head.unpack_from(payload, 0)
    recs = [list(r) for r in
            rec.iter_unpack(payload[head.size : head.size + s * rec.size])]
    off = head.size + s * rec.size
    parts: dict = {0: [], 1: [], 2: []}
    for kind in range(3):
        for i in range(s):
            ln = recs[i][4 + kind]
            parts[kind].append(payload[off : off + ln])
            off += ln
    parts[0][sidx] = parts[0][sidx][:keep]
    recs[sidx][4] = keep
    return b"".join([head.pack(s)] + [rec.pack(*r) for r in recs]
                    + parts[0] + parts[1] + parts[2])


def _truncate_shard(latent_payload: bytes, k: int, keep: int) -> bytes:
    """Rebuild a v3+ latent stream with shard ``k``'s chain cut to ``keep``
    bytes, directory record updated to match."""
    ldir = t_wire.LatentShardDirectory(latent_payload)
    payloads = [ldir.shard_payload(i) for i in range(ldir.n_shards)]
    payloads[k] = payloads[k][:keep]
    head_end = t_wire._LAT3_HEAD.size + t_wire._LAT3_CB.size \
        + 9 * len(ldir.symbols)
    parts = [latent_payload[:head_end]]
    parts.extend(t_wire._LAT3_LEN.pack(len(p)) for p in payloads)
    return b"".join(parts + payloads)


def _as_v3(blob: bytes, **replace) -> bytes:
    """Re-emit the container as v3 (no integrity stream, no family tag),
    with streams replaced by ``replace``: the cases below pin the
    *structural* detection that containers without digests rely on."""
    r = ContainerReader(blob)
    w = ContainerWriter(version=3)
    for name in r.names:
        if name == "integrity":
            continue
        payload = r[name]
        if name == "meta" and r.version >= 5:
            payload = payload[1:]
        w.add(name, replace.get(name, payload))
    return w.to_bytes()


class TestSelectiveEqualsFullSlice:
    @pytest.mark.parametrize(
        "species,time_range",
        [
            ([0], None),            # single species, all frames
            ([3], None),            # last species
            ([1, 2, 3], None),      # subset, preserving order
            ([3, 0], None),         # non-monotone order
            (None, (0, 4)),         # block-aligned window
            (None, (3, 7)),         # unaligned window (straddles blocks)
            (None, (5, 6)),         # single frame
            ([3], (2, 8)),          # species x window
            ([0, 3], (1, 5)),       # subset x unaligned window
        ],
    )
    def test_bitwise_equal(self, blob, full, species, time_range):
        out = t_codec.decompress(blob, species=species,
                                 time_range=time_range, **CPU)
        assert out.dtype == np.float32
        assert out.tobytes() == _sliced(full, species, time_range).tobytes()

    def test_random_subsets_and_windows(self, blob, full):
        rng = np.random.default_rng(0)
        pd = t_codec.PartialDecoder(blob, **CPU)
        for _ in range(6):
            k = int(rng.integers(1, S + 1))
            sel = sorted(rng.choice(S, size=k, replace=False).tolist())
            t0 = int(rng.integers(0, T))
            t1 = int(rng.integers(t0 + 1, T + 1))
            out = pd.decode(species=sel, time_range=(t0, t1))
            assert out.tobytes() == _sliced(full, sel, (t0, t1)).tobytes()

    def test_int_species_squeezes_axis(self, blob, full):
        out = t_codec.decompress(blob, species=3, **CPU)
        assert out.shape == full.shape[1:]
        assert out.tobytes() == full[3].tobytes()

    def test_negative_species_index(self, blob, full):
        out = t_codec.decompress(blob, species=-1, **CPU)
        assert out.tobytes() == full[-1].tobytes()

    def test_full_selection_equals_full_decode(self, blob, full):
        out = t_codec.decompress(blob, species=list(range(S)), **CPU)
        assert out.tobytes() == full.tobytes()

    def test_empty_species_matches_full_byte_for_byte(self, blob_and_report):
        """A species with NO stored corrections still rides the replay
        kernel when any sibling has corrections — the full decode applies
        (x + 0 @ U^T) to it, and the selective output must be *byte*
        identical to that slice (array_equal would mask a -0.0 flip)."""
        _, rep = blob_and_report
        arts = list(rep.artifact.species_guarantees)
        arts[3] = t_gae.GuaranteeArtifact.empty(
            nb=arts[0].n_blocks, d=arts[0].basis.shape[0], tau=arts[3].tau)
        art = dataclasses.replace(
            rep.artifact, species_guarantees=arts, _wire=None)
        for version in (5, 2, 1):
            mixed = t_codec.encode(art, version=version)
            full_mixed = t_codec.decompress(mixed, **CPU)
            out = t_codec.decompress(mixed, species=3, **CPU)
            assert out.tobytes() == full_mixed[3].tobytes()

    def test_gba_partial_decode(self, fitted):
        """The no-correction (GBA) variant rides the same selective path."""
        gba_blob = fitted.compress(target_nrmse=2e-2, skip_correction=True)
        gba_full = t_codec.decompress(gba_blob, **CPU)
        out = t_codec.decompress(gba_blob, species=[2, 3], time_range=(2, 6),
                                 **CPU)
        assert out.tobytes() == _sliced(gba_full, [2, 3], (2, 6)).tobytes()

    def test_attention_family_selective(self, data):
        """The attention family's decoder rides the same path."""
        gb = GBATCCodec(PipelineConfig(family="attention", latent=8,
                                       ae_steps=4, corr_steps=4,
                                       batch_size=16), **CPU)
        ablob = gb.compress(data, target_nrmse=TARGET)
        afull = t_codec.decompress(ablob, **CPU)
        for sel, win in (([1, 3], (4, 8)), (0, (1, 6)), (None, (0, 4))):
            out = t_codec.decompress(ablob, species=sel, time_range=win, **CPU)
            assert out.tobytes() == _sliced(afull, sel, win).tobytes()


class TestWindowGeometry:
    @pytest.mark.parametrize("chunk", [None, 16])
    def test_window_rows_are_the_full_decodes(self, blob, monkeypatch, chunk):
        """``_fused_vecs(rows=(b0, nb))`` runs a window in the full decode's
        launch geometry: every window, single rows included, is bitwise the
        full decode's rows, in one launch (NB = 40) and over 16-row chunks
        with a padded tail (the geometry of a field past the chunk size)."""
        if chunk is not None:
            monkeypatch.setattr(t_runtime, "_FUSED_CHUNK", chunk)
        head = t_runtime._decode_head(blob, **CPU)
        lat = t_runtime._latents32(head.latents.full(), head.latent_bin)
        rt, dec, corr = head.runtime, head.dec_state, head.corr_state
        whole = t_runtime._fused_vecs(rt, dec, corr, lat)
        nb = lat.shape[0]
        for b0, b1 in ((0, 1), (5, 6), (39, 40), (0, 20), (20, 40), (10, 35),
                       (15, 17), (0, 40)):
            part = t_runtime._fused_vecs(rt, dec, corr, lat[b0:b1],
                                         rows=(b0, nb))
            assert part.shape == (S, b1 - b0, whole.shape[2])
            assert part.numpy().tobytes() == \
                whole[:, b0:b1].contiguous().numpy().tobytes(), (b0, b1)
        with pytest.raises(ValueError, match="rows"):
            t_runtime._fused_vecs(rt, dec, corr, lat[:5], rows=(38, nb))
        if chunk is None:
            # what the geometry guards against, shown with ``pytest -s``: a
            # row decoded in a launch of its own length (no assertion: a
            # backend may or may not pick another algorithm for it)
            alone = max(float((t_runtime._fused_vecs(rt, dec, corr, lat[b:b + 1])
                               - whole[:, b:b + 1]).abs().max())
                        for b in (0, 5, 39))
            print(f"one-row windows decoded at their own length: max abs "
                  f"{alone!r} from the full decode's rows")


class TestPartialDecoder:
    def test_reuse_and_memoization(self, blob, full):
        pd = t_codec.PartialDecoder(blob, **CPU)
        a = pd.decode(species=[1], time_range=(0, 4))
        b = pd.decode(species=[1], time_range=(4, 8))
        assert np.concatenate([a, b], axis=1).tobytes() == full[[1]].tobytes()
        assert pd.shape == full.shape
        assert pd.n_species == S
        assert pd.version == 5

    def test_bytes_parsed_shrinks_with_selection(self, blob):
        pd = t_codec.PartialDecoder(blob, **CPU)
        assert pd.bytes_parsed(species=[0]) < pd.bytes_parsed()
        # every byte of a v2+ container is accounted to a purpose
        assert pd.bytes_parsed() == len(blob)
        sizes = [pd.bytes_parsed(species=list(range(k + 1)))
                 for k in range(S)]
        assert all(a < b for a, b in zip(sizes, sizes[1:]))
        assert sizes[-1] == len(blob)

    def test_invalid_selections_raise(self, blob):
        pd = t_codec.PartialDecoder(blob, **CPU)
        with pytest.raises(ValueError, match="out of range"):
            pd.decode(species=S)
        with pytest.raises(ValueError, match="out of range"):
            pd.decode(species=[-S - 1])
        with pytest.raises(ValueError, match="duplicate"):
            pd.decode(species=[1, 1])
        with pytest.raises(ValueError, match="empty"):
            pd.decode(species=[])
        for bad in ((0, 0), (3, 2), (-1, 4), (0, T + 1)):
            with pytest.raises(ValueError, match="time_range"):
                pd.decode(time_range=bad)

    def test_window_latent_bytes_scale_with_window(self, blob):
        """The O(window) claim: a one-block-group window entropy-decodes
        only its shard's chain."""
        pd = t_codec.PartialDecoder(blob, **CPU)
        total = pd.latent_bytes_parsed()
        half = pd.latent_bytes_parsed((0, 4))
        assert 0 < half < total
        assert half + pd.latent_bytes_parsed((4, 8)) == total
        assert pd.bytes_parsed(time_range=(4, 8)) < pd.bytes_parsed()
        assert pd.latent_bytes_parsed((0, T)) == total
        with pytest.raises(ValueError, match="time_range"):
            pd.latent_bytes_parsed((3, 2))

    def test_single_chain_versions_report_full_latent(self, blob_and_report):
        """v1/v2 carry one sequential chain: a window still walks it all,
        and the accounting says so."""
        _, rep = blob_and_report
        for version in (1, 2):
            pd = t_codec.PartialDecoder(
                t_codec.encode(rep.artifact, version=version), **CPU)
            assert pd.latent_bytes_parsed((4, 8)) == pd.latent_bytes_parsed()


class TestCorruptionIsolation:
    @pytest.fixture(scope="class")
    def bad_blob(self, blob):
        """v3 blob with species 2's coeff stream truncated mid-header
        (directory updated, so the framing itself stays valid)."""
        g = ContainerReader(blob)["guarantee"]
        return _as_v3(blob, guarantee=_truncate_species_coeff(g, 2, 8))

    @pytest.fixture(scope="class")
    def bad_shard_blob(self, blob):
        """v3 blob with shard 1's latent chain truncated."""
        lat = ContainerReader(blob)["latent"]
        return _as_v3(blob, latent=_truncate_shard(lat, k=1, keep=3))

    def test_corrupt_species_raises_named(self, bad_blob):
        with pytest.raises(ContainerFormatError,
                           match="guarantee stream 2") as ei:
            t_codec.decompress(bad_blob, species=[2], **CPU)
        assert (ei.value.stream, ei.value.unit) == ("guarantee", 2)

    def test_full_decode_of_corrupt_blob_raises(self, bad_blob):
        with pytest.raises(ContainerFormatError):
            t_codec.decompress(bad_blob, **CPU)

    def test_siblings_survive_corruption(self, bad_blob, full):
        """Sibling species decode from the same blob, bit-identical to the
        uncorrupted full decode — the bad stream poisons only itself."""
        pd = t_codec.PartialDecoder(bad_blob, **CPU)
        for sidx in (0, 1, 3):
            assert pd.decode(species=[sidx]).tobytes() == \
                full[[sidx]].tobytes()
        with pytest.raises(ContainerFormatError,
                           match="guarantee stream 2") as ei:
            pd.decode(species=[2])
        assert (ei.value.stream, ei.value.unit) == ("guarantee", 2)
        with pytest.raises(ContainerFormatError, match="guarantee stream 2"):
            pd.decode(species=[1, 2])
        # ... and does not wedge later healthy requests on the same decoder
        assert pd.decode(species=[1]).tobytes() == full[[1]].tobytes()

    def test_corrupt_shard_raises_named_siblings_survive(self, bad_shard_blob,
                                                         full):
        with pytest.raises(ContainerFormatError, match="latent shard 1") as ei:
            t_codec.decompress(bad_shard_blob, **CPU)
        assert (ei.value.stream, ei.value.unit) == ("latent", 1)
        pd = t_codec.PartialDecoder(bad_shard_blob, **CPU)
        assert pd.decode(time_range=(0, 4)).tobytes() == \
            _sliced(full, None, (0, 4)).tobytes()
        with pytest.raises(ContainerFormatError, match="latent shard 1"):
            pd.decode(time_range=(2, 6))
        assert pd.decode(species=[2], time_range=(1, 4)).tobytes() == \
            _sliced(full, [2], (1, 4)).tobytes()


class TestVersions:
    @pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
    def test_selective_on_every_version(self, blob_and_report, full, version):
        _, rep = blob_and_report
        b = t_codec.encode(rep.artifact, version=version)
        pd = t_codec.PartialDecoder(b, **CPU)
        assert pd.version == version
        for sel, win in (([2], (3, 7)), ([0, 3], None), (1, (4, 8))):
            assert pd.decode(species=sel, time_range=win).tobytes() == \
                _sliced(full, sel, win).tobytes()
        assert pd.bytes_parsed(species=[2]) < len(b)

    def test_reference_decode_handles_both_layouts(self, blob_and_report,
                                                   full):
        """The staged orchestration reads both guarantee layouts and stays
        the fused path's bit-identity oracle."""
        blob, rep = blob_and_report
        assert t_codec.decompress_reference(blob, **CPU).tobytes() == \
            full.tobytes()
        v1 = t_codec.encode(rep.artifact, version=1)
        assert t_codec.decompress_reference(v1, **CPU).tobytes() == \
            full.tobytes()


SELECTIONS = [(None, None), ([1], None), ([0, 3], (4, 8)), (2, (1, 6)),
              (None, (0, 4))]


class TestAgainstReference:
    @pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
    def test_bytes_parsed_match_reference(self, reference_x64, reference_blob,  # noqa: F811
                                          version):
        b = r_codec.encode(r_codec.decode_artifact(reference_blob),
                           version=version)
        rp, tp = r_codec.PartialDecoder(b), t_codec.PartialDecoder(b, **CPU)
        for sel, win in SELECTIONS:
            assert tp.bytes_parsed(sel, win) == rp.bytes_parsed(sel, win)
            assert tp.latent_bytes_parsed(win) == rp.latent_bytes_parsed(win)
        assert tp.shape == rp.shape and tp.version == rp.version == version

    def test_plan_slice_matches_reference(self, reference_x64, reference_blob):  # noqa: F811
        rp = r_codec.PartialDecoder(reference_blob)
        tp = t_codec.PartialDecoder(reference_blob, **CPU)
        for sel, win in SELECTIONS + [(-1, (7, 8)), ([3, 1], (2, 3))]:
            a = r_partial.plan_slice(rp._head, sel, win)
            b = t_partial.plan_slice(tp._head, sel, win)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert a.key == b.key

    def test_selective_within_bound_of_data(self, reference_blob, data):
        """The port's selective decode of a reference blob keeps the
        guarantee over whole blocks: the windows are block-aligned, and
        the error is normalised by the species' range over the field."""
        for sel, win in (([0, 2], (4, 8)), ([1, 3], (0, 4)), ([2], None)):
            out = t_codec.decompress(reference_blob, species=sel,
                                     time_range=win, **CPU)
            t0, t1 = win if win is not None else (0, T)
            for pos, s in enumerate(sel):
                x = data[s, t0:t1].astype(np.float64)
                rng = float(data[s].max() - data[s].min())
                err = np.sqrt(np.mean((x - out[pos]) ** 2)) / rng
                assert err <= TARGET * (1 + 1e-3), (s, win, err)
