"""The port's integrity layer: digests, salvage decode, fault sweep, files.

Mirrors the reference's ``tests/test_integrity.py`` on the port
(``device="cpu"``), all but its streaming-fit and loader-retry cases
(``fit_stream`` is not ported):

* a clean v5 container decodes bitwise identical to the v3 container of
  the same fit through every entry point, and stripping its digests and
  family tag yields exactly the v3 blob;
* *detected or harmless, never a silent wrong decode*: seeded bit flips
  over every region are all detected on v5 (``verify_blob`` and
  ``decompress``), and so are zero runs, splices and truncations; v1-v3
  carry no digests, so there only typed failure is required;
* ``on_error="salvage"`` returns every non-quarantined value bitwise equal
  to the clean decode, NaN elsewhere, and a ``DecodeReport`` saying which;
* salvage never touches the decode head cache, and raise-mode corruption
  evicts the poisoned head;
* ``write``/``read`` publish atomically and digest-verify on read;
* on the same reference-written blob, ``blob_regions`` and
  ``FaultInjector(seed)`` give the reference's regions and faulted bytes,
  and the port's ``DecodeReport`` equals the reference's.

Fits are tiny (S=4, T=8, 20x20 -> 40 blocks, two latent shards).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro import codec as r_codec
from repro.core.pipeline import PipelineConfig as RefConfig
from repro.data import s3d
from repro.testing import faults as r_faults
from repro_torch import codec as t_codec
from repro_torch.codec import format as t_wire
from repro_torch.codec import runtime as t_runtime
from repro_torch.core.container import (
    ContainerFormatError,
    ContainerReader,
    ContainerWriter,
)
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.testing.faults import FaultInjector, blob_regions

S, T, H, W = 4, 8, 20, 20
KW = dict(latent=8, conv_channels=(8, 16), ae_steps=10, corr_steps=8,
          batch_size=16)
TARGET = 1e-2
CPU = dict(device="cpu")
BT = 4  # paper geometry: 4 frames per time block-group


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
def blob_v3(blob_and_report):
    return t_codec.encode(blob_and_report[1].artifact, version=3)


@pytest.fixture(scope="module")
def clean(blob):
    return t_codec.decompress(blob, **CPU)


@pytest.fixture(scope="module")
def regions(blob):
    return blob_regions(blob)


def _region(regions, label):
    return next(r for r in regions if r.label == label)


def _cached(blob) -> bool:
    return t_runtime._head_key(blob, torch.device("cpu")) \
        in t_runtime._CACHE.heads


class TestV5Wire:
    def test_default_is_v5_and_verifies(self, blob):
        assert ContainerReader(blob).version == 5
        assert t_codec.verify_blob(blob) == 5

    def test_below_v4_structural_only(self, blob_v3):
        assert t_codec.verify_blob(blob_v3) == 3

    def test_stripping_digests_yields_exact_v3_blob(self, blob, blob_v3):
        """The v4/v5 additions are strictly additive on a conv fit."""
        r = ContainerReader(blob)
        w = ContainerWriter(version=3)
        for name in r.names:
            if name == "integrity":
                continue
            payload = r[name]
            if name == "meta":
                payload = payload[1:]  # the conv family tag
            w.add(name, payload)
        assert w.to_bytes() == blob_v3

    def test_full_decode_bit_identical_to_v3(self, blob_v3, clean):
        assert t_codec.decompress(blob_v3, **CPU).tobytes() == clean.tobytes()

    def test_partial_decode_bit_identical_to_v3(self, blob, blob_v3):
        pd5 = t_codec.PartialDecoder(blob, **CPU)
        pd3 = t_codec.PartialDecoder(blob_v3, **CPU)
        for sel, win in (([1, 3], (2, 8)), (2, (0, 4)), (None, (4, 8))):
            a = pd5.decode(species=sel, time_range=win)
            b = pd3.decode(species=sel, time_range=win)
            assert a.tobytes() == b.tobytes()

    def test_digest_overhead_is_small(self, blob, blob_v3):
        # a few CRCs per stream and unit: 4 bytes each plus framing
        assert len(blob) - len(blob_v3) < 0.05 * len(blob_v3)

    def test_every_byte_is_digest_covered(self, blob, regions):
        """Header + stream extents tile the blob exactly, so the sweep's
        per-region coverage is whole-blob coverage."""
        coarse = [r for r in regions
                  if r.label == "header" or r.label.startswith("stream:")]
        spans = sorted((r.lo, r.hi) for r in coarse)
        assert spans[0][0] == 0 and spans[-1][1] == len(blob)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


class TestFaultSweepV5:
    def test_bit_flips_all_detected(self, blob, regions):
        """verify_blob digest-checks 100% of the blob's bytes: every seeded
        single-bit flip over every region raises (CRC32 detects all
        single-bit errors)."""
        inj = FaultInjector(seed=101)
        flips = 0
        for reg in regions:
            for _ in range(40):
                bad, _ = inj.flip_bit(blob, reg)
                with pytest.raises(ContainerFormatError):
                    t_codec.verify_blob(bad)
                flips += 1
        assert flips >= 40 * 20

    def test_decode_paths_never_silently_wrong(self, blob, regions):
        """End to end through ``decompress``: every flip raises."""
        inj = FaultInjector(seed=202)
        for reg in regions:
            for _ in range(3):
                bad, _ = inj.flip_bit(blob, reg)
                with pytest.raises(ContainerFormatError):
                    t_codec.decompress(bad, **CPU)

    def test_detection_names_the_unit(self, blob, regions):
        inj = FaultInjector(seed=303)
        for label, stream, unit in (
            ("latent:shard1", "latent", 1),
            ("guarantee:s2:coeff", "guarantee", 2),
            ("guarantee:s3:basis", "guarantee", 3),
        ):
            bad, _ = inj.flip_bit(blob, _region(regions, label))
            with pytest.raises(ContainerFormatError) as ei:
                t_codec.decompress(bad, **CPU)
            assert (ei.value.stream, ei.value.unit) == (stream, unit)

    def test_zero_runs_and_splices_detected(self, blob, regions):
        inj = FaultInjector(seed=404)
        for reg in [r for r in regions if r.stream is not None]:
            bad, _ = inj.zero_run(blob, reg, length=16)
            if bad == blob:
                continue  # zeroed an already-zero run: genuinely harmless
            with pytest.raises(ContainerFormatError):
                t_codec.verify_blob(bad)
        for dst, src in (("latent:shard0", "latent:shard1"),
                         ("guarantee:s1:coeff", "guarantee:s3:coeff")):
            bad, _ = inj.splice(blob, _region(regions, dst),
                                _region(regions, src))
            if bad == blob:
                continue
            with pytest.raises(ContainerFormatError):
                t_codec.verify_blob(bad)

    def test_truncations_detected(self, blob):
        inj = FaultInjector(seed=505)
        for _ in range(20):
            bad, _ = inj.truncate(blob)
            with pytest.raises(ContainerFormatError):
                t_codec.verify_blob(bad)

    def test_window_decode_checks_what_it_reads(self, blob, regions, clean):
        """A corrupt shard outside the window does not block it (lazy
        verification); a window over it raises naming the shard."""
        bad, _ = FaultInjector(seed=606).flip_bit(
            blob, _region(regions, "latent:shard1"))
        pd = t_codec.PartialDecoder(bad, **CPU)
        assert pd.decode(time_range=(0, BT)).tobytes() == \
            np.ascontiguousarray(clean[:, 0:BT]).tobytes()
        with pytest.raises(ContainerFormatError) as ei:
            pd.decode(time_range=(BT, 2 * BT))
        assert (ei.value.stream, ei.value.unit) == ("latent", 1)


class TestFaultSweepLegacy:
    """v1-v3 carry no digests: corruption must raise ContainerFormatError
    or decode, never leak another exception."""

    @pytest.fixture(scope="class")
    def legacy_blobs(self, blob_and_report):
        art = blob_and_report[1].artifact
        return {v: t_codec.encode(art, version=v) for v in (1, 2, 3)}

    def test_structural_faults_detected_payload_flips_typed(self,
                                                            legacy_blobs):
        for version, b in legacy_blobs.items():
            clean = t_codec.decompress(b, **CPU)
            inj = FaultInjector(seed=700 + version)
            detected = 0
            for reg in blob_regions(b):
                for _ in range(3):
                    bad, _ = inj.flip_bit(b, reg)
                    try:
                        t_codec.decompress(bad, **CPU)
                    except ContainerFormatError:
                        detected += 1
            hdr = blob_regions(b, fine=False)[0]
            assert hdr.label == "header"
            for _ in range(10):
                bad, _ = inj.flip_bit(b, hdr)
                try:
                    out = t_codec.decompress(bad, **CPU)
                except ContainerFormatError:
                    continue
                assert out.tobytes() == clean.tobytes()
            assert detected > 0

    def test_truncation_always_detected_below_v4(self, legacy_blobs):
        inj = FaultInjector(seed=808)
        for b in legacy_blobs.values():
            for _ in range(10):
                bad, _ = inj.truncate(b)
                with pytest.raises(ContainerFormatError):
                    t_codec.decompress(bad, **CPU)


class TestSalvage:
    def test_clean_blob_salvage_is_clean_decode(self, blob, clean):
        field, rep = t_codec.decompress(blob, on_error="salvage", **CPU)
        assert rep.ok and rep.integrity and rep.version == 5
        assert rep.quarantined == []
        assert field.tobytes() == clean.tobytes()
        for sr in rep.species.values():
            assert sr.status == "verified"
            # tau = target * sqrt(D) at compress
            assert sr.nrmse_bound == pytest.approx(TARGET)
            assert sr.damaged_frames == []

    def test_corrupt_species_quarantined_siblings_bitwise(self, blob, regions,
                                                          clean):
        bad, _ = FaultInjector(11).flip_bit(
            blob, _region(regions, "guarantee:s2:index"))
        field, rep = t_codec.decompress(bad, on_error="salvage", **CPU)
        assert not rep.ok and rep.quarantined == [2]
        assert rep.species[2].status == "missing"
        assert np.isnan(field[2]).all()
        for i in (0, 1, 3):
            assert rep.species[i].status == "verified"
            assert field[i].tobytes() == clean[i].tobytes()
        assert [(f.stream, f.unit) for f in rep.failures] == [("guarantee", 2)]

    def test_corrupt_shard_salvaged_with_damage_map(self, blob, regions,
                                                    clean):
        bad, _ = FaultInjector(22).flip_bit(
            blob, _region(regions, "latent:shard1"))
        field, rep = t_codec.decompress(bad, on_error="salvage", **CPU)
        assert not rep.ok and rep.quarantined == []
        d = t_wire.LatentShardDirectory(ContainerReader(blob)["latent"])
        r0, r1 = d.shard_row_extent(1)
        per_frame = d.n_rows * BT // T
        want = [(r0 // per_frame * BT, r1 // per_frame * BT)]
        for sr in rep.species.values():
            assert sr.status == "salvaged" and sr.damaged_frames == want
        dmg = np.zeros(T, bool)
        for lo, hi in want:
            dmg[lo:hi] = True
        assert np.isnan(field[:, dmg]).all()
        assert field[:, ~dmg].tobytes() == clean[:, ~dmg].tobytes()

    def test_corrupt_shared_stream_all_missing(self, blob, regions):
        for label in ("stream:decoder", "stream:correction", "latent:head"):
            bad, _ = FaultInjector(33).flip_bit(blob, _region(regions, label))
            field, rep = t_codec.decompress(bad, on_error="salvage", **CPU)
            assert rep.quarantined == list(range(S))
            assert np.isnan(field).all() and field.shape == (S, T, H, W)

    def test_corrupt_integrity_stream_downgrades_to_unverified(
            self, blob, regions, clean):
        bad, _ = FaultInjector(44).flip_bit(
            blob, _region(regions, "stream:integrity"))
        field, rep = t_codec.decompress(bad, on_error="salvage", **CPU)
        assert not rep.integrity
        assert all(sr.status == "unverified" for sr in rep.species.values())
        assert field.tobytes() == clean.tobytes()

    def test_meta_corruption_still_raises(self, blob, regions):
        bad, _ = FaultInjector(55).flip_bit(
            blob, _region(regions, "stream:meta"))
        with pytest.raises(ContainerFormatError):
            t_codec.decompress(bad, on_error="salvage", **CPU)

    def test_salvage_respects_selection(self, blob, regions, clean):
        bad, _ = FaultInjector(66).flip_bit(
            blob, _region(regions, "guarantee:s2:coeff"))
        field, rep = t_codec.decompress(bad, species=[1, 2], time_range=(2, 6),
                                        on_error="salvage", **CPU)
        assert field.shape == (2, 4, H, W)
        assert sorted(rep.species) == [1, 2]
        assert rep.species[1].status == "verified"
        assert rep.species[2].status == "missing"
        assert field[0].tobytes() == \
            np.ascontiguousarray(clean[1, 2:6]).tobytes()
        assert np.isnan(field[1]).all()
        # corruption outside the selection is not even read
        field2, rep2 = t_codec.decompress(bad, species=[0, 3],
                                          on_error="salvage", **CPU)
        assert rep2.ok and field2.tobytes() == clean[[0, 3]].tobytes()

    def test_salvage_on_partial_decoder(self, blob, regions, clean):
        bad, _ = FaultInjector(77).flip_bit(
            blob, _region(regions, "guarantee:s0:basis"))
        pd = t_codec.PartialDecoder(bad, **CPU)
        field, rep = pd.decode(on_error="salvage")
        assert rep.quarantined == [0]
        assert field[1:].tobytes() == clean[1:].tobytes()
        with pytest.raises(ContainerFormatError):
            pd.decode(species=[0])

    def test_salvage_below_v4_is_unverified(self, blob_v3):
        field, rep = t_codec.decompress(blob_v3, on_error="salvage", **CPU)
        assert rep.version == 3 and not rep.integrity
        assert all(sr.status == "unverified" for sr in rep.species.values())
        assert field.tobytes() == \
            t_codec.decompress(blob_v3, **CPU).tobytes()

    def test_invalid_on_error_rejected(self, blob):
        with pytest.raises(ValueError, match="on_error"):
            t_codec.PartialDecoder(blob, **CPU).decode(on_error="ignore")


class TestCacheIsolation:
    def test_salvage_never_touches_head_cache(self, blob, regions):
        t_codec.clear_decode_cache()
        bad, _ = FaultInjector(seed=1).flip_bit(
            blob, _region(regions, "guarantee:s2:coeff"))
        t_codec.decompress(bad, on_error="salvage", **CPU)
        assert not _cached(bad)
        assert len(t_runtime._CACHE.heads) == 0

    def test_raise_mode_corruption_evicts_poisoned_head(self, blob, regions):
        t_codec.clear_decode_cache()
        bad, _ = FaultInjector(seed=2).flip_bit(
            blob, _region(regions, "guarantee:s3:coeff"))
        # the head parse succeeds (guarantee digests check lazily), the
        # decode raises — the poisoned head must not linger
        with pytest.raises(ContainerFormatError):
            t_codec.decompress(bad, **CPU)
        assert not _cached(bad)

    def test_salvage_leaves_clean_entries_alone(self, blob, regions, clean):
        t_codec.clear_decode_cache()
        assert t_codec.decompress(blob, **CPU).tobytes() == clean.tobytes()
        assert _cached(blob)
        bad, _ = FaultInjector(seed=3).flip_bit(
            blob, _region(regions, "guarantee:s1:coeff"))
        t_codec.decompress(bad, on_error="salvage", **CPU)
        assert _cached(blob)
        assert t_codec.decompress(blob, **CPU).tobytes() == clean.tobytes()

    def test_salvage_evicts_own_key_on_entry(self, blob):
        t_codec.clear_decode_cache()
        t_codec.decompress(blob, **CPU)
        assert _cached(blob)
        _, rep = t_codec.decompress(blob, on_error="salvage", **CPU)
        assert rep.ok and not _cached(blob)


class TestAtomicIO:
    def test_write_read_round_trip(self, blob, tmp_path):
        p = tmp_path / "field.gbtc"
        t_codec.write(p, blob)
        assert t_codec.read(p) == blob
        assert os.listdir(tmp_path) == ["field.gbtc"]  # no tmp litter

    def test_write_replaces_atomically(self, blob, tmp_path):
        p = tmp_path / "field.gbtc"
        p.write_bytes(b"previous contents")
        t_codec.write(p, blob)
        assert p.read_bytes() == blob

    def test_read_verifies_by_default(self, blob, tmp_path, regions):
        p = tmp_path / "field.gbtc"
        bad, _ = FaultInjector(seed=9).flip_bit(
            blob, _region(regions, "stream:decoder"))
        p.write_bytes(bad)
        with pytest.raises(ContainerFormatError) as ei:
            t_codec.read(p)
        assert ei.value.stream == "decoder"
        assert t_codec.read(p, verify=False) == bad

    def test_codec_facade_write_read(self, fitted, tmp_path):
        p = tmp_path / "x.gbtc"
        blob = fitted.write(p, target_nrmse=TARGET)
        assert GBATCCodec.read(p) == blob
        assert fitted.decompress(blob, species=[1], time_range=(0, 4)).shape \
            == (1, 4, H, W)


def _fault_tuple(f):
    return (f.kind, dataclasses.astuple(f.region), f.offset, f.detail)


class TestAgainstReference:
    @pytest.fixture(scope="class")
    def reference_blob(self, reference_x64, data):  # noqa: F811
        return r_codec.GBATCCodec(RefConfig(**KW)).compress(
            data, target_nrmse=TARGET)

    @pytest.mark.parametrize("version", [1, 3, 5])
    def test_regions_and_faults_match_reference(self, reference_blob,
                                                version):
        b = r_codec.encode(r_codec.decode_artifact(reference_blob),
                           version=version)
        for fine in (True, False):
            ours = [dataclasses.astuple(r) for r in blob_regions(b, fine=fine)]
            theirs = [dataclasses.astuple(r)
                      for r in r_faults.blob_regions(b, fine=fine)]
            assert ours == theirs
        ours_inj, theirs_inj = FaultInjector(seed=7), r_faults.FaultInjector(7)
        regs = blob_regions(b)
        for k, reg in enumerate(regs):
            rreg = r_faults.Region(**dataclasses.asdict(reg))
            src = regs[(k + 3) % len(regs)]
            rsrc = r_faults.Region(**dataclasses.asdict(src))
            for ours, theirs in (
                (ours_inj.flip_bit(b, reg), theirs_inj.flip_bit(b, rreg)),
                (ours_inj.zero_run(b, reg, 5), theirs_inj.zero_run(b, rreg, 5)),
                (ours_inj.splice(b, reg, src), theirs_inj.splice(b, rreg, rsrc)),
                (ours_inj.truncate(b), theirs_inj.truncate(b)),
            ):
                assert ours[0] == theirs[0]
                assert _fault_tuple(ours[1]) == _fault_tuple(theirs[1])
            assert t_codec.verify_blob(b) == r_codec.verify_blob(b) == version

    @pytest.mark.parametrize("labels,selection", [
        (("guarantee:s2:index",), (None, None)),
        (("latent:shard1",), (None, None)),
        (("guarantee:s1:coeff", "latent:shard0"), ([0, 1, 3], (2, 8))),
        (("stream:decoder",), ([2], None)),
        (("stream:integrity",), (None, (4, 8))),
    ])
    def test_decode_report_matches_reference(self, reference_x64,  # noqa: F811
                                             reference_blob, labels,
                                             selection):
        regs = blob_regions(reference_blob)
        inj = FaultInjector(seed=31)
        bad = reference_blob
        for label in labels:
            bad, _ = inj.flip_bit(bad, _region(regs, label))
        sel, win = selection
        f_ref, r_ref = r_codec.decompress(bad, species=sel, time_range=win,
                                          on_error="salvage")
        f_port, r_port = t_codec.decompress(bad, species=sel, time_range=win,
                                            on_error="salvage", **CPU)
        assert (r_port.version, r_port.integrity, r_port.ok) == \
            (r_ref.version, r_ref.integrity, r_ref.ok)
        assert r_port.quarantined == r_ref.quarantined
        assert [(f.stream, f.unit, f.offset) for f in r_port.failures] == \
            [(f.stream, f.unit, f.offset) for f in r_ref.failures]
        assert sorted(r_port.species) == sorted(r_ref.species)
        for i, ours in r_port.species.items():
            theirs = r_ref.species[i]
            assert (ours.status, ours.damaged_frames) == \
                (theirs.status, theirs.damaged_frames)
            assert ours.nrmse_bound == theirs.nrmse_bound
        assert f_port.shape == f_ref.shape
        np.testing.assert_array_equal(np.isnan(f_port), np.isnan(f_ref))
