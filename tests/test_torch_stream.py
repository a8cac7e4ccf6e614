"""The port's streaming ingest: ``fit_stream`` with loader retry.

Mirrors the reference's ``tests/test_integrity.py::TestLoaderRetry`` (all
six cases) and ``::TestV4Wire::test_fit_stream_writes_identical_blob`` on
the port (``device="cpu"``):

* ``retry_with_backoff`` restarts on transient faults with exponential
  backoff, re-raises when exhausted, and never retries anything else;
  on the same call sequences it does exactly what the reference's does;
* ``fit_stream`` over a time-chunked loader writes the same container
  bytes as ``fit`` on the whole field, also when the loader fails: twice
  in the first pass (backoffs ``[0.1, 0.2]``) or once in each pass
  (``[0.1, 0.1]``);
* validation errors are never retried;
* ``compress`` after a streamed fit reports the per-species NRMSE from the
  normalized block vectors, the original field never having existed.

Fits are tiny (S=6, T=16, 20x16 -> 64 blocks, four chunks of 4 frames).
"""

import numpy as np
import pytest

from repro.train import fault_tolerance as r_ft
from repro_torch.core import metrics
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core.container import ContainerReader
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.data import s3d
from repro_torch.train import fault_tolerance as t_ft
from repro_torch.train.fault_tolerance import retry_with_backoff

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def small_cfg():
    return s3d.S3DConfig(n_species=6, n_time=16, height=20, width=16, seed=3)


@pytest.fixture(scope="module")
def small_data(small_cfg):
    return s3d.generate(small_cfg)["species"]


@pytest.fixture(scope="module")
def pipe_cfg():
    return PipelineConfig(ae_steps=8, corr_steps=4, conv_channels=(8, 16),
                          seed=0)


@pytest.fixture(scope="module")
def fitted(small_data, pipe_cfg):
    return GBATCCodec(pipe_cfg, **CPU).fit(small_data)


@pytest.fixture(scope="module")
def streamed(small_cfg, pipe_cfg):
    return GBATCCodec(pipe_cfg, **CPU).fit_stream(
        s3d.S3DChunkLoader(small_cfg, chunk_frames=4))


class _FlakyLoader:
    """Wraps a chunk loader; raises OSError mid-iteration a set number of
    times, then behaves cleanly: the transient-I/O model fit_stream's
    retry must absorb."""

    def __init__(self, inner, fail_times):
        self._inner = inner
        self._fails = fail_times
        self.shape = inner.shape

    def chunks(self):
        n = 0
        for c in self._inner.chunks():
            yield c
            n += 1
            if self._fails > 0 and n == 2:
                self._fails -= 1
                raise OSError("transient read fault")


class _PassFaults:
    """Wraps a chunk loader; the ``chunks()`` calls numbered in
    ``fail_on`` (from 0) raise OSError after their second chunk."""

    def __init__(self, inner, fail_on):
        self._inner = inner
        self._fail_on = set(fail_on)
        self.calls = 0
        self.shape = inner.shape

    def chunks(self):
        call, self.calls = self.calls, self.calls + 1
        for n, c in enumerate(self._inner.chunks(), 1):
            yield c
            if call in self._fail_on and n == 2:
                raise OSError("transient read fault")


class TestLoaderRetry:
    def test_retry_with_backoff_unit(self):
        calls = []
        sleeps = []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("flaky")
            return "done"

        out = retry_with_backoff(fn, max_retries=3, backoff=0.5,
                                 sleep=sleeps.append)
        assert out == "done" and len(calls) == 3
        assert sleeps == [0.5, 1.0]  # exponential: backoff * 2**attempt

    def test_retry_exhaustion_reraises(self):
        def fn():
            raise OSError("always")

        with pytest.raises(OSError, match="always"):
            retry_with_backoff(fn, max_retries=2, backoff=0,
                               sleep=lambda s: None)

    def test_non_retryable_propagates_immediately(self):
        calls = []

        def fn():
            calls.append(1)
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            retry_with_backoff(fn, max_retries=5, sleep=lambda s: None)
        assert len(calls) == 1

    def test_flaky_loader_yields_bit_identical_container(
        self, small_cfg, pipe_cfg, streamed
    ):
        """Two transient faults: each restart re-reads from the top, and
        the final container matches a clean run byte for byte."""
        sleeps = []
        flaky = _FlakyLoader(
            s3d.S3DChunkLoader(small_cfg, chunk_frames=4), fail_times=2
        )
        c_flaky = GBATCCodec(pipe_cfg, **CPU).fit_stream(
            flaky, _sleep=sleeps.append
        )
        assert c_flaky.compress(target_nrmse=1e-2) \
            == streamed.compress(target_nrmse=1e-2)
        # both faults land in the first pass (the wrapper raises after
        # the second chunk until its faults are spent): its two restarts
        # back off 0.1 s, then 0.2 s
        assert sleeps == [0.1, 0.2]

    def test_one_fault_in_each_pass(self, small_cfg, pipe_cfg, streamed):
        """One fault in the min/max pass and one in the block pass: each
        pass restarts once, with its own first backoff."""
        sleeps = []
        loader = _PassFaults(
            s3d.S3DChunkLoader(small_cfg, chunk_frames=4), fail_on={0, 2})
        c = GBATCCodec(pipe_cfg, **CPU).fit_stream(loader, _sleep=sleeps.append)
        assert sleeps == [0.1, 0.1]
        assert loader.calls == 4
        assert c.compress(target_nrmse=1e-2) \
            == streamed.compress(target_nrmse=1e-2)

    def test_persistent_faults_exhaust_retries(self, small_cfg, pipe_cfg):
        flaky = _FlakyLoader(
            s3d.S3DChunkLoader(small_cfg, chunk_frames=4), fail_times=99
        )
        with pytest.raises(OSError, match="transient"):
            GBATCCodec(pipe_cfg, **CPU).fit_stream(
                flaky, loader_retries=2, _sleep=lambda s: None
            )

    def test_validation_errors_never_retried(self, pipe_cfg):
        class Misaligned:
            shape = (6, 16, 20, 16)

            def __init__(self):
                self.iterations = 0

            def chunks(self):
                self.iterations += 1
                yield np.zeros((6, 3, 20, 16), np.float32)

        loader = Misaligned()
        with pytest.raises(ValueError, match="block depth"):
            GBATCCodec(pipe_cfg, **CPU).fit_stream(
                loader, _sleep=lambda s: None
            )
        assert loader.iterations == 1


class TestStreamedFit:
    def test_fit_stream_writes_identical_blob(self, fitted, streamed):
        """The streaming-fit path lands on the same container bytes as
        the materialized fit."""
        blob_stream = streamed.compress(target_nrmse=1e-2)
        blob_full = fitted.compress(target_nrmse=1e-2)
        assert ContainerReader(blob_stream).version == 5
        assert blob_stream == blob_full

    def test_report_without_the_field(self, small_data, streamed):
        """NRMSE from the normalized block vectors: within float rounding
        of the data-space NRMSE of the same reconstruction, and inside the
        bound."""
        target = 1e-2
        rep = streamed.pipeline.compress(target_nrmse=target)
        assert streamed.pipeline._data is None
        data_space = np.array([metrics.nrmse(small_data[s], rep.recon[s])
                               for s in range(small_data.shape[0])])
        np.testing.assert_allclose(rep.per_species_nrmse, data_space,
                                   rtol=1e-4)
        assert (rep.per_species_nrmse <= target * (1 + 1e-3)).all()
        assert rep.compression_ratio == small_data.nbytes / len(
            rep.artifact.to_bytes())

    def test_streamed_state_equals_the_full_fit(self, fitted, streamed):
        a, b = fitted.pipeline, streamed.pipeline
        assert a._shape == b._shape and a._data_nbytes == b._data_nbytes
        for x, y in zip(a._norm, b._norm):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        assert a._vecs_orig.tobytes() == b._vecs_orig.tobytes()
        assert a._latents.tobytes() == b._latents.tobytes()

    def test_block_array_allocated_once_per_pass_attempt(
        self, small_cfg, pipe_cfg, monkeypatch
    ):
        """The second pass allocates its block array inside the pass, so a
        restart refills a fresh array from row 0."""
        shapes = []
        real = t_pipeline._host_alloc

        def spy(shape, dtype):
            shapes.append(tuple(shape))
            return real(shape, dtype)

        monkeypatch.setattr(t_pipeline, "_host_alloc", spy)
        pipe = t_pipeline.GBATCPipeline(
            PipelineConfig(ae_steps=1, corr_steps=1, conv_channels=(8, 16)),
            n_species=6, **CPU)
        pipe.fit_stream(_PassFaults(
            s3d.S3DChunkLoader(small_cfg, chunk_frames=4), fail_on={1}),
            _sleep=lambda s: None)
        # call 0 is the min/max pass, which allocates nothing; call 1, the
        # block pass, fails after two chunks and call 2 starts over
        assert shapes == [(64, 6, 4, 5, 4)] * 2
        assert set(pipe.timings) >= {"ingest", "fit_total", "fit_ae"}

    def test_codec_fit_stream_keeps_the_device(self, small_cfg, streamed):
        assert streamed.fitted and str(streamed.pipeline.device) == "cpu"
        assert streamed.pipeline.n_species == small_cfg.n_species

    @pytest.mark.parametrize("bad, match", [
        (np.zeros((5, 4, 20, 16), np.float32), "does not match"),
        (np.zeros((6, 0, 20, 16), np.float32), "block depth"),
    ])
    def test_bad_chunks_raise(self, pipe_cfg, bad, match):
        class One:
            shape = (6, 4, 20, 16)

            def chunks(self):
                yield bad

        with pytest.raises(ValueError, match=match):
            GBATCCodec(pipe_cfg, **CPU).fit_stream(One())

    def test_empty_loader_raises(self, pipe_cfg):
        class Empty:
            shape = (6, 0, 20, 16)

            def chunks(self):
                return iter(())

        with pytest.raises(ValueError, match="no chunks"):
            GBATCCodec(pipe_cfg, **CPU).fit_stream(Empty())


# -- retry_with_backoff against the reference's, on the same sequences ------
_SEQUENCES = [
    ("ok",),
    ("os", "ok"),
    ("os", "io", "os", "ok"),
    ("os", "os", "os", "os", "ok"),
    ("value",),
    ("os", "value"),
    ("step", "ok"),
    ("os",) * 9,
]


def _run(module, seq, **kw):
    """Drive ``module.retry_with_backoff`` over a scripted call sequence;
    returns (outcome, calls, sleeps, retries seen by on_retry)."""
    calls, sleeps, seen = [], [], []
    errors = {"os": OSError, "io": IOError, "value": ValueError,
              "step": module.StepFailure}

    def fn():
        step = seq[len(calls)]
        calls.append(step)
        if step == "ok":
            return len(calls)
        raise errors[step](step)

    try:
        out = ("returned", module.retry_with_backoff(
            fn, sleep=sleeps.append,
            on_retry=lambda a, e: seen.append((a, type(e).__name__)), **kw))
    except Exception as e:
        out = ("raised", type(e).__name__, str(e))
    return out, calls, sleeps, seen


@pytest.mark.parametrize("seq", _SEQUENCES)
@pytest.mark.parametrize("kw", [{}, dict(max_retries=1, backoff=0.25),
                                dict(max_retries=5, backoff=0.0),
                                dict(retry_on=(OSError,))])
def test_retry_with_backoff_matches_the_reference(seq, kw):
    assert _run(t_ft, seq, **kw) == _run(r_ft, seq, **kw)


def test_watchdog_matches_the_reference():
    rng = np.random.default_rng(0)
    times = rng.uniform(0.9, 1.1, 60)
    times[[10, 25, 40]] = 5.0
    a, b = t_ft.Watchdog(), r_ft.Watchdog()
    assert [a.observe(i, t) for i, t in enumerate(times)] \
        == [b.observe(i, t) for i, t in enumerate(times)]
    assert a.straggler_steps == b.straggler_steps == [10, 25, 40]
    assert a.median == b.median
