"""The port's invariant checker, ``repro_torch.analysis``, against the reference's.

* lint parity: the port's ``lint_tree`` with the five shared rules gives the
  reference's findings and suppressed lists, (rule, path, line, detail) for
  each, on the reference's fixture tree, on ``src/repro`` and on
  ``src/repro_torch`` (which both packages find clean); the port's own two
  rules fire exactly at planted violations;
* findings, suppression tags and the baseline file behave as the
  reference's (the same baseline bytes for the same findings);
* the wire schema's tables and stream sets are the reference's value by
  value, conformance is clean on the live layout and loud under mutation,
  and the fault harness takes its vocabulary from it;
* the trace audit flags each planted violation exactly once, its registry
  carries the reference's 13 program names, is clean on the CPU, and
  allows fp64 and host reads exactly where the reference's ``jaxpr_audit``
  does;
* the CLI's exit status and ``--json`` keys are the reference CLI's;
* the codec trainer's step updates its carries in place, bitwise the
  functional AdamW update, and ``fit`` leaves the caller's parameters alone.
"""

import functools
import json
import os
import textwrap

import numpy as np
import pytest
import torch
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro.analysis import findings as r_findings
from repro.analysis import jaxpr_audit as r_audit
from repro.analysis import wire_schema as r_schema
from repro.analysis.__main__ import main as r_main
from repro.analysis.lint import lint_tree as r_lint
from repro_torch.analysis import findings as t_findings
from repro_torch.analysis import rules as t_rules
from repro_torch.analysis import trace_audit
from repro_torch.analysis import wire_schema as t_schema
from repro_torch.analysis.__main__ import main as t_main
from repro_torch.analysis.lint import lint_tree as t_lint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE_TREE = os.path.join(HERE, "fixtures", "lint", "tree")
FIXTURE_CORPUS = os.path.join(HERE, "fixtures", "lint", "testcorpus")
CPU = torch.device("cpu")


def _rows(items):
    return [(f.rule, f.path, f.line, f.detail) for f in items]


@functools.lru_cache(maxsize=None)
def _lints(root, tests):
    """(the reference's lint, the port's lint under all its rules) of a tree,
    computed once per test process."""
    return r_lint(root, tests), t_lint(root, tests)


# ---------------------------------------------------------------------------
# lint parity and the port's rules


@pytest.mark.parametrize("root,tests", [
    (FIXTURE_TREE, FIXTURE_CORPUS),
    (os.path.join(REPO, "src", "repro"), HERE),
    (os.path.join(REPO, "src", "repro_torch"), HERE),
], ids=["fixture_tree", "src_repro", "src_repro_torch"])
def test_shared_rules_match_the_reference(root, tests):
    want, got = _lints(root, tests)
    # the rules are per file, so the port's run under all of its rules,
    # restricted to the shared ones, is its run under the shared ones alone
    shared = {r.RULE for r in t_rules.SHARED_FILE_RULES + t_rules.TREE_RULES}
    assert _rows(f for f in got.findings if f.rule in shared) == _rows(want.findings)
    assert _rows(f for f in got.suppressed if f.rule in shared) == _rows(
        want.suppressed)
    assert got.files_scanned == want.files_scanned


def test_shared_rules_alone_are_the_reference_on_the_fixture_tree():
    got = t_lint(FIXTURE_TREE, FIXTURE_CORPUS, file_rules=t_rules.SHARED_FILE_RULES)
    want, _ = _lints(FIXTURE_TREE, FIXTURE_CORPUS)
    assert _rows(got.findings) == _rows(want.findings)
    assert _rows(got.suppressed) == _rows(want.suppressed)


def test_reference_trees_counts():
    assert len(_lints(FIXTURE_TREE, FIXTURE_CORPUS)[0].findings) == 16
    src, _ = _lints(os.path.join(REPO, "src", "repro"), HERE)
    assert (len(src.findings), len(src.suppressed)) == (0, 14)


def test_port_tree_is_clean_under_every_rule():
    _, res = _lints(os.path.join(REPO, "src", "repro_torch"), HERE)
    assert res.findings == [] and res.parse_errors == []
    supp = {(f.rule, f.path) for f in res.suppressed}
    # the codec's one clock read, and the dry run's deliberate broad catch
    assert ("determinism", "core/stopwatch.py") in supp
    assert ("typed-errors", "launch/dryrun.py") in supp
    clocks = [f for f in res.suppressed if f.rule == "determinism"]
    assert [f.path for f in clocks] == ["core/stopwatch.py"]


def _plant(root, files: dict) -> str:
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(textwrap.dedent(text).lstrip("\n"))
    return str(root)


def test_reference_import_fires_exactly_at_plants(tmp_path):
    root = _plant(tmp_path, {"core/bad_import.py": """
        import os
        import jax.numpy as jnp
        from repro.core import gae
        from repro_torch.core import gae as fine
        import importlib
        m = importlib.import_module("jaxlib")
        n = importlib.import_module("repro_torch.codec")
        """})
    res = t_lint(root, None, file_rules=t_rules.PORT_FILE_RULES)
    assert [(f.rule, f.path, f.line) for f in res.findings] == [
        ("reference-import", "core/bad_import.py", 2),
        ("reference-import", "core/bad_import.py", 3),
        ("reference-import", "core/bad_import.py", 6),
    ]


_WRAPPERS = {
    "kernels/block_quant.py": """
        from repro_torch.kernels import ref
        from repro_torch.kernels._wrap import launch, refuse_grad


        def block_quant(x):
            \"\"\"Checks before refusing gradients.\"\"\"
            check(x)
            refuse_grad("block_quant", x)
            launch("block_quant", f, (), x.device, e)
            return x


        def cpu_branch(x):
            \"\"\"Refuses first; the plain version only on the CPU.\"\"\"
            refuse_grad("cpu_branch", x)
            if x.device.type == "cpu":
                return ref.block_quant_ref(x)
            launch("cpu_branch", f, (), x.device, e)
            return x
        """,
    "kernels/flash_attention.py": """
        from repro_torch.kernels import _wrap, ref


        def _go(q):
            _wrap.launch("flash_attention", f, (), q.device, e)


        def flash_attention(q):
            _wrap.refuse_grad("flash_attention", q)
            try:
                _go(q)
            except RuntimeError:
                return ref.flash_attention_ref(q)
            return q


        def reraises(q):
            _wrap.refuse_grad("reraises", q)
            try:
                _go(q)
            except RuntimeError as err:
                raise ValueError("launch refused") from err
            return q
        """,
}


def test_kernel_wrapper_fires_exactly_at_plants(tmp_path):
    files = dict(_WRAPPERS)
    # the same code outside the five wrapper modules is not in scope
    files["kernels/ops.py"] = _WRAPPERS["kernels/flash_attention.py"]
    root = _plant(tmp_path, files)
    res = t_lint(root, None, file_rules=t_rules.PORT_FILE_RULES)
    got = [(f.path, f.line, f.detail.split(":")[0]) for f in res.findings]
    assert got == [
        ("kernels/block_quant.py", 7,
         "wrapper 'block_quant' does not refuse gradients first"),
        ("kernels/flash_attention.py", 12,
         "handler in wrapper 'flash_attention' catches a launch without "
         "re-raising"),
        ("kernels/flash_attention.py", 13,
         "wrapper 'flash_attention' reaches the plain version "
         "'flash_attention_ref' outside an explicit CPU-device branch"),
    ]
    assert {f.rule for f in res.findings} == {"kernel-wrapper"}


def test_kernel_wrapper_rule_reads_the_real_wrappers():
    """Every public wrapper of the port reaches a launch, so the rule's
    call graph sees them all (a rename that hid a launch would pass
    silently otherwise)."""
    import ast

    from repro_torch.analysis.rules import kernel_wrapper as kw

    public = {}
    for rel in sorted(kw.WRAPPER_MODULES):
        with open(os.path.join(REPO, "src", "repro_torch", rel)) as fh:
            mod = kw._Module(ast.parse(fh.read()))
        public[rel] = sorted(n for n in mod.funcs
                             if not n.startswith("_") and mod.reaches_launch(n))
    assert public == {
        "kernels/block_quant.py": ["block_quant"],
        "kernels/flash_attention.py": ["flash_attention"],
        "kernels/gbatc_project.py": [
            "gbatc_correct", "gbatc_correct_batched", "gbatc_project",
            "gbatc_project_batched", "gbatc_select_accumulate"],
        "kernels/rglru_scan.py": ["rglru_scan"],
        "kernels/rwkv6_scan.py": ["rwkv6_scan"],
    }


# ---------------------------------------------------------------------------
# suppressions and the baseline (the reference's cases, on the port)


def test_line_tag_scopes_to_its_line_and_rule():
    src = "x = 1\ny = pack()  # repro: allow[wire-centralization]\n"
    s = t_findings.scan_suppressions(src)
    assert s.allows("wire-centralization", 2)
    assert not s.allows("wire-centralization", 1)
    assert not s.allows("typed-errors", 2)
    assert vars(s) == vars(r_findings.scan_suppressions(src))


def test_comma_list_and_file_tag():
    src = ("# repro: allow-file[determinism]\n"
           "z = 3  # repro: allow[typed-errors,decode-purity]\n")
    s = t_findings.scan_suppressions(src)
    assert s.allows("determinism", 999)
    assert s.allows("typed-errors", 2) and s.allows("decode-purity", 2)
    assert not s.allows("typed-errors", 1)
    assert vars(s) == vars(r_findings.scan_suppressions(src))


def test_baseline_round_trip_ignores_line_numbers(tmp_path):
    f1 = t_findings.Finding("typed-errors", "a.py", 10, "bare except")
    f2 = t_findings.Finding("determinism", "b.py", 20, "import random")
    path = tmp_path / "baseline.json"
    t_findings.save_baseline(path, [f1])
    records = t_findings.load_baseline(path)
    moved = t_findings.Finding("typed-errors", "a.py", 99, "bare except")
    new, baselined, stale = t_findings.apply_baseline([moved, f2], records)
    assert (new, baselined, stale) == ([f2], [moved], [])


def test_stale_entries_surface_without_failing():
    records = [{"rule": "typed-errors", "path": "gone.py", "detail": "bare except"}]
    assert t_findings.apply_baseline([], records) == ([], [], records)


def test_missing_baseline_is_empty():
    assert t_findings.load_baseline("/nonexistent/baseline.json") == []


def test_baseline_bytes_equal_the_reference(tmp_path):
    rows = [("typed-errors", "a.py", 10, "bare except"),
            ("determinism", "core/x.py", 3, "stdlib random imported"),
            ("wire-centralization", "b.py", 7, "struct.pack outside")]
    t_findings.save_baseline(tmp_path / "t.json",
                             [t_findings.Finding(*r) for r in rows])
    r_findings.save_baseline(tmp_path / "r.json",
                             [r_findings.Finding(*r) for r in rows])
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "r.json").read_bytes()


def test_port_baseline_is_empty():
    path = os.path.join(REPO, "src", "repro_torch", "analysis", "baseline.json")
    assert t_findings.load_baseline(path) == []


# ---------------------------------------------------------------------------
# wire schema


def test_schema_tables_equal_the_reference():
    for name in ("OUTER_MAGIC", "LAT3_MAGIC", "ITG_MAGIC", "OUTER_RECORDS",
                 "STREAM_RECORDS", "VERSIONS", "FAMILY_TAGS", "GUARANTEE_PARTS"):
        assert getattr(t_schema, name) == getattr(r_schema, name), name


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_stream_sets_equal_the_reference(version):
    for s in (1, 3, 58):
        for corr in (False, True):
            assert (t_schema.expected_stream_set(version, s, corr)
                    == r_schema.expected_stream_set(version, s, corr))
    with pytest.raises(ValueError):
        t_schema.expected_stream_set(6, 1, False)


def test_conformance_clean_on_live_layout():
    assert t_schema.check_conformance() == []


def test_mutated_live_magic_is_caught(monkeypatch):
    from repro_torch.core import container

    monkeypatch.setattr(container, "MAGIC", b"GBTX")
    assert any("outer magic" in f.detail for f in t_schema.check_conformance())


def test_mutated_record_layout_is_caught(monkeypatch):
    import struct

    from repro_torch.codec import format as wire

    monkeypatch.setattr(wire, "_GDIR_REC", struct.Struct("<ddIIQQ"))
    assert any("gdir_rec" in f.detail for f in t_schema.check_conformance())


def test_region_kind_is_the_reference_vocabulary():
    from repro_torch.testing import faults

    assert ([(k.name, k.value) for k in t_schema.RegionKind]
            == [(k.name, k.value) for k in r_schema.RegionKind])
    assert t_schema.RegionKind.GUARANTEE_SPECIES_PART.label(
        unit=2, part="coeff") == "guarantee:s2:coeff"
    assert faults.RegionKind is t_schema.RegionKind
    assert faults.GUARANTEE_PARTS is t_schema.GUARANTEE_PARTS


# ---------------------------------------------------------------------------
# the trace audit


def _audit_toy(fn, args, **kw):
    spec = trace_audit.ProgramSpec(name="toy", build=lambda: (fn, args), **kw)
    report = trace_audit.AuditReport()
    trace_audit._audit_program(spec, report, CPU)
    return report


_BIG = torch.ones(1 << 19)  # 2 MiB of fp32 the program reads but is not given


def _functional_step(params, state, batch):
    new = {k: p - 0.1 * batch for k, p in params.items()}
    return new, {"m": {k: m + 1 for k, m in state["m"].items()}}, 0.0


@pytest.mark.parametrize("fn,args,kw,what", [
    (lambda x: x.double() * 2, (torch.ones(4),), {}, "promotes to float64"),
    (lambda x: x * float(x.sum()), (torch.ones(4),), {}, "host sync"),
    (lambda x: x[x > 0], (torch.ones(4),), {}, "host sync"),
    (lambda x: x.to("meta"), (torch.ones(4),), {}, "device transfer"),
    (lambda x: x + _BIG[:4], (torch.ones(4),), {}, "captured tensors"),
    (_functional_step, ({"w": torch.ones(3)}, {"m": {"w": torch.zeros(3)}}, 1.0),
     {"check_carry": True}, "in place"),
], ids=["fp64", "item", "bool_mask", "to_meta", "captured", "not_in_place"])
def test_audit_flags_each_planted_violation_once(fn, args, kw, what):
    report = _audit_toy(fn, args, **kw)
    assert len(report.findings) == 1, report.findings
    assert what in report.findings[0].detail


def test_audit_passes_the_allowances():
    step = lambda p, s, b: (p, s, 0.0)  # noqa: E731
    args = ({"w": torch.ones(3)}, {"m": {"w": torch.zeros(3)}}, 1.0)
    assert _audit_toy(step, args, check_carry=True).findings == []
    assert _audit_toy(lambda x: x.double(), (torch.ones(2),),
                      allow_f64=True).findings == []
    assert _audit_toy(lambda x: float(x.sum()), (torch.ones(2),),
                      allowed_syncs=1).findings == []


def test_setup_guard_refuses_a_float64_default():
    torch.set_default_dtype(torch.float64)
    try:
        report = trace_audit.audit("cpu")
    finally:
        torch.set_default_dtype(torch.float32)
    assert report.programs == {}
    assert ["audit aborted" in f.detail for f in report.findings] == [True]


@pytest.fixture(scope="module")
def port_report():
    """The registry over the workload of a real (tiny) run, as the card's
    ``analysis_path`` builds it: a fitted conv codec and an attention
    artifact.
    (The CLI test below runs it over the seeded tiny workload.)"""
    from repro_torch import codec
    from repro_torch.core.blocking import BlockGeometry
    from repro_torch.core.pipeline import GBATCCodec, PipelineConfig

    data = np.random.default_rng(0).standard_normal((3, 4, 8, 8)).astype(np.float32)
    kw = dict(geometry=BlockGeometry(bt=2, ph=4, pw=4), latent=8, ae_steps=2,
              corr_steps=2, batch_size=8)
    conv = GBATCCodec(PipelineConfig(conv_channels=(4,), **kw), device="cpu")
    conv.compress(data, target_nrmse=1e-2)
    attn = GBATCCodec(PipelineConfig(family="attention", arch=(16, 2, 1, 32), **kw),
                      device="cpu")
    blob, rep = attn.compress_report(data, target_nrmse=1e-2)
    # the compress report's artifact (as the card's phase passes it) and
    # the blob's decoded one give the same workload
    assert codec.decode_artifact(blob, device="cpu").latent_q.tobytes() == \
        rep.artifact.latent_q.tobytes()
    w = trace_audit.workload_from(conv.pipeline, rep.artifact)
    assert w.x.shape == (3, 8, 32) and w.attn_latents.shape == (8, 8)
    return trace_audit.audit(workload=w)


@pytest.fixture(scope="module")
def reference_programs(reference_x64):  # noqa: F811
    specs = r_audit._program_specs()
    report = r_audit.AuditReport()
    for spec in specs:
        r_audit._audit_program(spec, report)
    return specs, report


def test_registry_is_clean_on_the_cpu(port_report):
    assert port_report.findings == []
    assert port_report.caches["decode_runtime_reused"]
    assert port_report.caches["jit_cache_entries"] is None
    stats = port_report.programs
    assert stats["trainer_scan_log_every"].syncs == {"_local_scalar_dense": 2}
    for name in ("trainer_stream_step", "trainer_scan_hot", "trainer_mesh_dp",
                 "trainer_mesh_dp_quantized"):
        assert stats[name].in_place is True, name
    assert stats["trainer_mesh_dp"].collectives == 1
    assert stats["gbatc_project_shard"].collectives == 0


def test_registry_names_are_the_reference(port_report, reference_programs):
    specs, _ = reference_programs
    assert list(port_report.programs) == [s.name for s in specs]
    assert len(specs) == 13


def test_fp64_and_host_reads_where_the_reference_allows(port_report,
                                                        reference_programs):
    specs, report = reference_programs
    assert report.findings == []
    t_specs = {s.name: s for s in trace_audit.program_specs(
        trace_audit.tiny_workload("cpu"))}
    for spec in specs:
        if spec.name.startswith("trainer_mesh_dp"):
            continue  # the reference's run here is one device; the port's four
        got = port_report.programs[spec.name]
        want = report.programs[spec.name]
        assert t_specs[spec.name].allow_f64 == spec.allow_f64, spec.name
        assert (got.n_syncs == 0) == (want.callbacks == {}), spec.name
        assert (t_specs[spec.name].allowed_syncs > 0) == spec.allow_debug_callback
        if got.f64_ops:
            assert spec.allow_f64, spec.name
        assert want.f64_eqns == 0 or spec.allow_f64


# ---------------------------------------------------------------------------
# the CLI


def test_cli_repo_is_clean_on_the_cpu():
    assert t_main(["--device", "cpu"]) == 0


def test_cli_fixture_violations_exit_nonzero():
    assert t_main(["--no-audit", "--root", FIXTURE_TREE,
                   "--tests", FIXTURE_CORPUS]) == 1


def test_cli_write_baseline_then_clean(tmp_path):
    path = str(tmp_path / "base.json")
    args = ["--no-audit", "--root", FIXTURE_TREE, "--tests", FIXTURE_CORPUS,
            "--baseline", path]
    assert t_main(args + ["--write-baseline"]) == 0
    assert t_main(args) == 0


def test_cli_json_keys_are_the_reference(tmp_path):
    args = ["--no-audit", "--root", FIXTURE_TREE, "--tests", FIXTURE_CORPUS]
    t_main(args + ["--json", str(tmp_path / "t.json")])
    r_main(args + ["--json", str(tmp_path / "r.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "r.json").read_text())
    assert sorted(got) == sorted(want)
    # the shared rules count alike; the port's own rule also sees the
    # fixture's three imports of the reference package
    assert {k: v for k, v in got["rule_counts"].items()
            if k != "reference-import"} == want["rule_counts"]
    assert got["rule_counts"]["reference-import"] == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_cli_audit_raises_without_cuda_or_device_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_main(["--root", FIXTURE_TREE, "--tests", FIXTURE_CORPUS])


# ---------------------------------------------------------------------------
# the in-place trainer step


def _params(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((5, 3), generator=g).to(dtype),
            "b": torch.randn((7,), generator=g).to(dtype)}


def _adamw_expression(cfg, grads, state, params):
    """AdamW as one functional expression a leaf (the optimizer's arithmetic
    before its update was shared with the in-place ``update_``)."""
    from repro_torch.train import optimizer as opt

    step = state["step"] + 1
    grads, gnorm = opt.clip_by_global_norm(grads, cfg.grad_clip) \
        if cfg.grad_clip is not None else (grads, opt.global_norm(grads))
    lr = opt.schedule(cfg, step)
    f = np.float32
    b1c = float(f(1.0) - f(cfg.b1) ** f(step))
    b2c = float(f(1.0) - f(cfg.b2) ** f(step))
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m = cfg.b1 * state["m"][k] + (1.0 - cfg.b1) * g32
        v = cfg.b2 * state["v"][k] + (1.0 - cfg.b2) * torch.square(g32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, None)])
def test_update_and_update_in_place_keep_the_bits(dtype, weight_decay, clip):
    from repro_torch.train import optimizer as opt

    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=weight_decay, grad_clip=clip,
                          warmup_steps=2, total_steps=6)
    want, want_state = _params(0, dtype), opt.init_state(_params(0, dtype))
    got, got_state = _params(0, dtype), opt.init_state(_params(0, dtype))
    mine, mine_state = _params(0, dtype), opt.init_state(_params(0, dtype))
    ptrs = [t.data_ptr() for t in (*mine.values(), *mine_state["m"].values(),
                                   *mine_state["v"].values())]
    for step in range(4):
        grads = _params(10 + step, dtype)
        given, kept = got, {k: v.clone() for k, v in got.items()}
        want, want_state, want_norm = _adamw_expression(cfg, grads, want_state,
                                                        want)
        got, got_state, metrics = opt.update(cfg, grads, got_state, got)
        _, _, metrics_ = opt.update_(cfg, grads, mine_state, mine)
        for k in want:
            for a, b in ((want[k], got[k]), (want[k], mine[k]),
                         (want_state["m"][k], got_state["m"][k]),
                         (want_state["m"][k], mine_state["m"][k]),
                         (want_state["v"][k], got_state["v"][k]),
                         (want_state["v"][k], mine_state["v"][k])):
                assert a.dtype == b.dtype and torch.equal(a, b), (step, k)
        assert want_state["step"] == got_state["step"] == mine_state["step"]
        assert metrics["lr"] == metrics_["lr"]
        assert torch.equal(metrics["grad_norm"], want_norm)
        # update is functional: the step's inputs are untouched
        assert all(torch.equal(given[k], v) for k, v in kept.items())
    assert ptrs == [t.data_ptr() for t in (*mine.values(),
                                           *mine_state["m"].values(),
                                           *mine_state["v"].values())]


def test_fit_copies_the_callers_params_and_steps_in_place():
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop

    def loss(p, x):
        return torch.mean(torch.square(x @ p["a"] - p["b"][:3]))

    trainer = train_loop.MiniBatchTrainer(loss, opt.adamw_cfg(1e-2, 5))
    params = _params(0)
    before = {k: v.clone() for k, v in params.items()}
    data = np.random.default_rng(0).standard_normal((16, 5)).astype(np.float32)
    out, losses = trainer.fit(params, (data,), steps=5, batch_size=4, seed=0,
                              device="cpu")
    for k in params:
        assert torch.equal(params[k], before[k])
        assert out[k].data_ptr() != params[k].data_ptr()
        assert not torch.equal(out[k], before[k])
    state = opt.init_state(out)
    ptrs = [t.data_ptr() for t in (*out.values(), *state["m"].values())]
    batch = (torch.from_numpy(data[:4]),)
    for _ in range(2):
        out, state, _ = trainer.step(out, state, batch)
    assert ptrs == [t.data_ptr() for t in (*out.values(), *state["m"].values())]
