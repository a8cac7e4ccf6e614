"""``chip_smoke.py``'s host-side helpers, on the CPU: the SASS loop count
the ``build`` phase reports, and the child process that runs
``CHILD_PHASES`` beside the codec paths (its phase lines read back, its
failures failing the run, the run's arguments handed on)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

OPS = ("FFMA R1, R2, R3, R4", "HMMA.1688.F32.TF32 R8, R4, R6, R8", "DMMA.8x8x4 R8, R4, R6, R8",
       "IADD3 R1, R1, 0x1, RZ", "LDS.128 R4, [R2]", "@P0 FFMA R1, R2, R3, R1",
       "@!UP1 HMMA.16816.F32 R8, R4, R6, R8", "MOV R1, R2")


def sass_function(rng, n: int, loops: list) -> str:
    """A ``cuobjdump -sass`` function body of ``n`` instructions, with a
    backward ``BRA`` at the end of each (start, end) loop."""
    ends = {end: start for start, end in loops}
    lines = []
    for i in range(n):
        addr = i * 16
        if i in ends:
            op = f"@P1 BRA 0x{ends[i] * 16:x}"
        else:
            op = OPS[rng.integers(len(OPS))]
        lines.append(f"        /*{addr:04x}*/                   {op} ;"
                     "            /* 0x000fe20000000f00 */")
    lines.append(f"        /*{n * 16:04x}*/                   BRA 0x{n * 16:x};")  # forward
    return "kernel\n" + "\n".join(lines) + "\n"


def brute_force(func: str) -> list:
    """Each loop's body by a scan of every instruction (the count before
    ``loop_counts``)."""
    import re

    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
    spans = [(int(t, 16), int(a, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/[^;\n]*\bBRA\b[^;\n]*0x([0-9a-f]+)", func)
        if int(t, 16) < int(a, 16)]
    out = []
    for lo, hi in spans:
        body = [o for a, o in ins if lo <= a <= hi]
        out.append((not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans),
                    len(body), sum(o.startswith("FFMA") for o in body),
                    sum(o.startswith(("HMMA", "DMMA")) for o in body)))
    return out


@pytest.mark.parametrize("seed, loops", [
    (0, [(3, 40)]),
    (1, [(2, 50), (10, 20), (30, 45)]),       # two inner loops in one outer
    (2, [(5, 9), (12, 30), (14, 18), (25, 29), (1, 60)]),
    (3, []),                                  # no loop
])
def test_loop_counts_equal_a_scan_of_every_instruction(seed, loops):
    func = sass_function(np.random.default_rng(seed), 64, loops)
    got = chip_smoke.loop_counts(func)
    assert got == brute_force(func)
    assert len(got) == len(loops)
    # loops in the order of their backward branches; innermost: no other inside
    assert [c[0] for c in got] == [
        not any(a >= lo and b <= hi and (a, b) != (lo, hi) for a, b in loops)
        for lo, hi in sorted(loops, key=lambda span: span[1])]


def child_printing(tmp_path, lines: list, rc: int = 0) -> dict:
    """A started child (as ``start_child`` returns it) that prints
    ``lines`` and exits ``rc``."""
    out = open(tmp_path / "child.out", "w+")
    code = "import sys; print(%r); sys.exit(%d)" % ("\n".join(lines), rc)
    p = subprocess.Popen([sys.executable, "-c", code], stdout=out)
    chip_smoke.CHILDREN.append(p)
    return {"phases": ["wide_block_path", "lm_serve_path"], "proc": p, "out": out,
            "started": 0.0}


def test_join_child_returns_each_phase_line_and_reprints_the_lines(tmp_path, capsys):
    lines = [json.dumps({"phase": "generate", "seconds": 1.0}),
             json.dumps({"phase": "wide_block_path", "step": 1}),
             json.dumps({"phase": "wide_block_path", "launches": {"k": 1}}),
             "not json: a card line",
             json.dumps({"phase": "lm_serve_path", "launches": {"lm_serve": {"k": 2}}})]
    got = chip_smoke.join_child(child_printing(tmp_path, lines))
    assert got == {"wide_block_path": {"phase": "wide_block_path", "launches": {"k": 1}},
                   "lm_serve_path": json.loads(lines[-1])}
    assert capsys.readouterr().out.splitlines() == lines
    assert chip_smoke.CHILDREN == []


@pytest.mark.parametrize("rc, lines", [
    (1, [json.dumps({"phase": "wide_block_path"}), json.dumps({"phase": "lm_serve_path"})]),
    (0, [json.dumps({"phase": "wide_block_path"})]),  # a phase line missing
])
def test_join_child_fails_the_run(tmp_path, rc, lines):
    with pytest.raises(SystemExit) as e:
        chip_smoke.join_child(child_printing(tmp_path, lines, rc))
    assert e.value.code == 1


def test_start_child_hands_on_the_run_arguments(tmp_path, monkeypatch):
    seen = {}

    class Popen:
        def __init__(self, argv, **kw):
            seen["argv"], seen["cwd"] = argv, kw["cwd"]

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", Popen)
    monkeypatch.setattr(chip_smoke, "CHILDREN", [])
    args = argparse.Namespace(launches=21, frames=8, height=64, width=96, ae_steps=7,
                              attn_ae_steps=9, corr_steps=5, seed=3)
    child = chip_smoke.start_child(args, ["wide_head_path", "lm_serve_path"])
    child["out"].close()
    argv = seen["argv"]
    assert argv[1:4] == [chip_smoke.__file__, "--child", "wide_head_path,lm_serve_path"]
    opts = dict(zip(argv[4::2], argv[5::2]))
    assert opts == {"--launches": "21", "--frames": "8", "--height": "64",
                    "--width": "96", "--ae-steps": "7", "--attn-ae-steps": "9",
                    "--corr-steps": "5", "--seed": "3"}
    assert seen["cwd"] == chip_smoke.ROOT
    assert set(chip_smoke.CHILD_PHASES) == {"wide_block_path", "wide_head_path",
                                            "lm_serve_path"}
