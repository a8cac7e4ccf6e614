"""The port's decode service (:mod:`repro_torch.serve.decode_service`).

Mirrors every test of the reference's ``tests/test_serve_service.py`` on
the port (``device="cpu"``, the kernels' plain versions), at its fixture
size (S=8, T=8, 40x32, 60/30 fit steps, conv channels (16, 32)):

* every slice the service returns (batched, coalesced, deduped, fallback,
  threaded) is **bitwise** the port's serial ``PartialDecoder`` answer
  for the same request, which is the slice of the full decode;
* N concurrent threads issuing random slices, through the service and
  directly through ``PartialDecoder``, each get the bitwise serial answer;
* a corrupt request coalesced into a batch gets its structured
  ``ContainerFormatError`` (or its salvage report) alone; healthy
  batch-mates in the same dispatch still succeed;
* scheduler stats show genuine coalescing: fewer fused dispatches than
  requests under concurrent load.

Against the reference: the same ``_Pending`` batch over a port-written
blob through the port's ``_tick`` and the reference's gives equal
``ServeStats``, and slices within the cross-backend decode tolerance of
``tests/test_torch_codec.py::test_reference_blob_decodes_in_port``.
"""

import dataclasses
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro.data import s3d
from repro_torch import codec as t_codec
from repro_torch.codec import runtime as t_runtime
from repro_torch.core.container import ContainerFormatError
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.serve import DecodeService, ServeStats
from repro_torch.serve.decode_service import _Pending, _merge_intervals
from repro_torch.testing.faults import FaultInjector, blob_regions

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def small_data():
    cfg = s3d.S3DConfig(n_species=8, n_time=8, height=40, width=32, seed=11)
    return s3d.generate(cfg)["species"]


@pytest.fixture(scope="module")
def blob(small_data):
    cfg = PipelineConfig(ae_steps=60, corr_steps=30, conv_channels=(16, 32))
    return GBATCCodec(cfg, **CPU).fit(small_data).compress_report(
        target_nrmse=1e-3
    )[0]


@pytest.fixture(scope="module")
def full(blob):
    return t_codec.decompress(blob, **CPU)


def _service(**kw):
    return DecodeService(**CPU, **kw)


def _cached(blob) -> bool:
    return t_runtime._head_key(blob, torch.device("cpu")) \
        in t_runtime._CACHE.heads


def _requests(rng, s, t, n):
    """n random (species, time_range) selections over an (s, t) field."""
    out = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            species = int(rng.integers(0, s))
        elif kind == 1:
            k = int(rng.integers(1, 4))
            species = list(rng.choice(s, size=k, replace=False))
            species = [int(x) for x in species]
        else:
            species = None
        if rng.integers(0, 2):
            t0 = int(rng.integers(0, t - 1))
            t1 = int(rng.integers(t0 + 1, t + 1))
            window = (t0, t1)
        else:
            window = None
        out.append((species, window))
    return out


def _sliced(full, species, time_range):
    t0, t1 = time_range if time_range is not None else (0, full.shape[1])
    if species is None:
        return full[:, t0:t1]
    if isinstance(species, int):
        return full[species, t0:t1]
    return full[list(species)][:, t0:t1]


def _bitwise(got, want) -> bool:
    want = np.ascontiguousarray(want)
    return got.dtype == want.dtype and got.shape == want.shape \
        and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
class TestMergeIntervals:
    def test_merges_overlap_and_adjacency(self):
        assert _merge_intervals([(4, 8), (0, 2), (1, 5), (8, 9)]) == \
            [(0, 9)]
        assert _merge_intervals([(0, 2), (3, 5)]) == [(0, 2), (3, 5)]
        assert _merge_intervals([(2, 4)]) == [(2, 4)]

    def test_matches_the_reference(self):
        from repro.serve.decode_service import _merge_intervals as r_merge

        rng = np.random.default_rng(3)
        for _ in range(200):
            spans = []
            for _ in range(int(rng.integers(1, 8))):
                b0 = int(rng.integers(0, 30))
                spans.append((b0, b0 + int(rng.integers(1, 10))))
            assert _merge_intervals(spans) == r_merge(spans)


# ---------------------------------------------------------------------------
class TestServiceEquivalence:
    def test_random_mix_bitwise_equals_serial(self, blob, full):
        rng = np.random.default_rng(7)
        reqs = _requests(rng, full.shape[0], full.shape[1], 24)
        pd = t_codec.PartialDecoder(blob, **CPU)
        serial = [pd.decode(sp, tr) for sp, tr in reqs]
        with _service() as svc:
            svc.register("b", blob)
            futs = [svc.submit("b", sp, tr) for sp, tr in reqs]
            outs = [f.result(timeout=120) for f in futs]
        for (sp, tr), out, want in zip(reqs, outs, serial):
            assert _bitwise(out, want), (sp, tr)
            assert _bitwise(out, _sliced(full, sp, tr)), (sp, tr)
        assert svc.stats.completed == len(reqs) and svc.stats.errors == 0

    def test_tick_coalesces_and_dedups(self, blob, full):
        svc = _service()
        svc.register("b", blob)
        reqs = [
            _Pending("b", 3, (0, 4), "raise", Future()),
            _Pending("b", 3, (0, 4), "raise", Future()),   # exact dup
            _Pending("b", [1, 3], (0, 4), "raise", Future()),
            _Pending("b", 5, (2, 6), "raise", Future()),
        ]
        svc._tick(reqs)
        for req in reqs:
            sp, tr = req.species, req.time_range
            assert _bitwise(req.future.result(0), _sliced(full, sp, tr)), \
                (sp, tr)
        assert svc.stats.deduped == 1
        assert svc.stats.coalesced >= 3
        # 4 requests; windows (0,4) and (2,6) overlap into ONE merged
        # row interval -> one fused dispatch total
        assert svc.stats.dispatches == 1
        assert svc.stats.completed == 4 and svc.stats.errors == 0

    def test_unknown_blob_id_fails_alone(self, blob, full):
        with _service() as svc:
            svc.register("b", blob)
            bad = svc.submit("nope", 0)
            good = svc.submit("b", 0)
            with pytest.raises(KeyError):
                bad.result(timeout=120)
            assert _bitwise(good.result(timeout=120), full[0])

    def test_submit_requires_started(self, blob):
        svc = _service()
        svc.register("b", blob)
        with pytest.raises(RuntimeError):
            svc.submit("b", 0)
        svc.start()
        try:
            svc.submit("b", 0).result(timeout=120)
        finally:
            svc.stop()
        with pytest.raises(RuntimeError):
            svc.submit("b", 0)
        with pytest.raises(RuntimeError):
            svc.start()

    def test_malformed_request_fails_alone(self, blob, full):
        with _service() as svc:
            svc.register("b", blob)
            bad = svc.submit("b", species=99)
            dup = svc.submit("b", species=[2, 2])
            good = svc.submit("b", species=2)
            with pytest.raises(ValueError):
                bad.result(timeout=120)
            with pytest.raises(ValueError):
                dup.result(timeout=120)
            assert _bitwise(good.result(timeout=120), full[2])

    @pytest.mark.parametrize("kw, match", [
        (dict(max_batch=0), "max_batch"),
        (dict(device="cpu", max_batch=-3), "max_batch"),
    ])
    def test_bad_construction(self, kw, match):
        with pytest.raises(ValueError, match=match):
            DecodeService(**{"device": "cpu", **kw})

    def test_bad_on_error_rejected_at_submit(self, blob):
        with _service() as svc:
            svc.register("b", blob)
            with pytest.raises(ValueError, match="on_error"):
                svc.submit("b", 0, on_error="ignore")
        assert svc.stats.requests == 0

    def test_registry(self, blob):
        svc = _service()
        assert svc.register("b", bytearray(blob)) == "b"
        svc.register("a", blob)
        assert svc.blob_ids() == ["a", "b"]
        svc.unregister("a")
        svc.unregister("missing")
        assert svc.blob_ids() == ["b"]
        assert svc.device == torch.device("cpu")

    def test_stats_as_dict(self):
        st = ServeStats(requests=3, completed=2, errors=1)
        d = st.as_dict()
        assert d["requests"] == 3 and d["errors"] == 1
        assert set(d) == {f.name for f in dataclasses.fields(ServeStats)}


# ---------------------------------------------------------------------------
class TestConcurrency:
    N_THREADS = 8
    PER_THREAD = 6

    def test_threads_through_partial_decoder(self, blob, full):
        t_codec.clear_decode_cache()
        rng = np.random.default_rng(13)
        plans = [
            _requests(rng, full.shape[0], full.shape[1], self.PER_THREAD)
            for _ in range(self.N_THREADS)
        ]
        results = [[None] * self.PER_THREAD for _ in range(self.N_THREADS)]
        errors = []

        def worker(i):
            try:
                pd = t_codec.PartialDecoder(blob, **CPU)
                for j, (sp, tr) in enumerate(plans[i]):
                    results[i][j] = pd.decode(sp, tr)
            except Exception as e:  # surfaced below, not swallowed
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(self.N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == []
        for i in range(self.N_THREADS):
            for j, (sp, tr) in enumerate(plans[i]):
                assert _bitwise(results[i][j], _sliced(full, sp, tr)), \
                    (i, sp, tr)

    def test_threads_through_service(self, blob, full):
        t_codec.clear_decode_cache()
        rng = np.random.default_rng(17)
        plans = [
            _requests(rng, full.shape[0], full.shape[1], self.PER_THREAD)
            for _ in range(self.N_THREADS)
        ]
        results = [[None] * self.PER_THREAD for _ in range(self.N_THREADS)]
        errors = []
        with _service(max_batch=16) as svc:
            svc.register("b", blob)

            def worker(i):
                try:
                    for j, (sp, tr) in enumerate(plans[i]):
                        results[i][j] = svc.decode("b", sp, tr)
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(self.N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert errors == []
        for i in range(self.N_THREADS):
            for j, (sp, tr) in enumerate(plans[i]):
                assert _bitwise(results[i][j], _sliced(full, sp, tr)), \
                    (i, sp, tr)
        total = self.N_THREADS * self.PER_THREAD
        assert svc.stats.completed == total
        # closed-loop contention must actually coalesce work: strictly
        # fewer fused dispatches than requests
        assert svc.stats.dispatches < total


# ---------------------------------------------------------------------------
class TestCorruptIsolation:
    @pytest.fixture(scope="class")
    def bad_guarantee(self, blob):
        regions = {r.label: r for r in blob_regions(blob)}
        bad, _ = FaultInjector(seed=5).flip_bit(
            blob, regions["guarantee:s3:coeff"]
        )
        return bad

    def test_corrupt_species_fails_alone_in_batch(self, blob, full,
                                                  bad_guarantee):
        t_codec.clear_decode_cache()
        svc = _service()
        svc.register("bad", bad_guarantee)
        reqs = [
            _Pending("bad", 1, None, "raise", Future()),
            _Pending("bad", 3, None, "raise", Future()),   # the corrupt one
            _Pending("bad", [2, 5], (0, 4), "raise", Future()),
        ]
        svc._tick(reqs)
        with pytest.raises(ContainerFormatError) as exc:
            reqs[1].future.result(0)
        assert exc.value.unit == 3 and exc.value.stream == "guarantee"
        # healthy batch-mates coalesced with it still succeed, bitwise
        assert _bitwise(reqs[0].future.result(0), full[1])
        assert _bitwise(reqs[2].future.result(0), full[[2, 5]][:, 0:4])
        # serial raise-mode semantics preserved: the bad head is evicted
        assert not _cached(bytes(bad_guarantee))
        assert svc.stats.errors == 1 and svc.stats.completed == 2
        assert svc.stats.fallbacks >= 1

    def test_corrupt_latent_shard_fails_only_covering_windows(self, blob,
                                                              full):
        regions = {r.label: r for r in blob_regions(blob)}
        shard_labels = [k for k in regions if k.startswith("latent:shard")]
        assert len(shard_labels) >= 2  # time-sharded fixture
        bad, _ = FaultInjector(seed=6).flip_bit(
            blob, regions["latent:shard0"]
        )
        t_codec.clear_decode_cache()
        svc = _service()
        svc.register("bad", bad)
        t = full.shape[1]
        covering = _Pending("bad", 2, (0, t // 2), "raise", Future())
        clear = _Pending("bad", 2, (t // 2, t), "raise", Future())
        svc._tick([covering, clear])
        with pytest.raises(ContainerFormatError) as exc:
            covering.future.result(0)
        assert exc.value.stream == "latent"
        assert _bitwise(clear.future.result(0), full[2, t // 2:t])

    def test_salvage_rides_with_clean_batchmates(self, blob, full,
                                                 bad_guarantee):
        t_codec.clear_decode_cache()
        with _service() as svc:
            svc.register("bad", bad_guarantee)
            svc.register("good", blob)
            salv = svc.submit("bad", on_error="salvage")
            clean = svc.submit("good", 4)
            field, report = salv.result(timeout=120)
            assert _bitwise(clean.result(timeout=120), full[4])
        assert report.quarantined == [3]
        assert np.isnan(field[3]).all()
        healthy = [s for s in range(full.shape[0]) if s != 3]
        assert _bitwise(field[healthy], full[healthy])
        assert svc.stats.salvaged == 1
        # salvage never writes the clean-decode head cache
        assert not _cached(bytes(bad_guarantee))

    def test_corrupt_head_fails_whole_group_structured(self, blob):
        regions = {r.label: r for r in blob_regions(blob)}
        bad, _ = FaultInjector(seed=8).flip_bit(blob, regions["stream:meta"])
        t_codec.clear_decode_cache()
        svc = _service()
        svc.register("bad", bad)
        reqs = [_Pending("bad", s, None, "raise", Future())
                for s in (0, 1)]
        svc._tick(reqs)
        for req in reqs:
            with pytest.raises(ContainerFormatError):
                req.future.result(0)
        assert svc.stats.errors == 2 and svc.stats.dispatches == 0


# ---------------------------------------------------------------------------
def _batch():
    """The same mixed batch for both packages' ``_tick``: a dup, an
    overlap, a disjoint window, an unknown blob and a malformed request."""
    return [
        ("b", 3, (0, 4)), ("b", 3, (0, 4)), ("b", [1, 3], (0, 4)),
        ("b", 5, (2, 6)), ("b", None, (4, 8)), ("b", [0, 7], None),
        ("nope", 0, None), ("b", 99, None),
    ]


def test_reference_tick_agrees(reference_x64, blob, full):  # noqa: F811
    """A port-written blob, the same ``_Pending`` batch: the port's and the
    reference's ``_tick`` count the same ``ServeStats`` and fail the same
    requests, and their slices agree within the cross-backend tolerance."""
    from repro import codec as r_codec
    from repro.serve import DecodeService as RefService
    from repro.serve.decode_service import _Pending as RefPending

    r_codec.clear_decode_cache()
    port, ref = _service(), RefService()
    out = {}
    for name, svc, pending in (("port", port, _Pending), ("ref", ref, RefPending)):
        svc.register("b", blob)
        reqs = [pending(b, sp, tr, "raise", Future()) for b, sp, tr in _batch()]
        svc._tick(reqs)
        out[name] = reqs
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    atol = 1e-4 * float(np.abs(full).max())
    for (b, sp, tr), p, r in zip(_batch(), out["port"], out["ref"]):
        pe, re_ = p.future.exception(0), r.future.exception(0)
        assert type(pe) is type(re_), (b, sp, tr, pe, re_)
        if pe is not None:
            continue
        got, want = p.future.result(0), r.future.result(0)
        assert _bitwise(got, _sliced(full, sp, tr)), (sp, tr)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
