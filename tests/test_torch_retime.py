"""``tools/retime_tree.py`` runs another checkout's ``chip_smoke.py`` with
that checkout's package and this checkout's timers."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_retime_tree_runs_the_other_checkout_with_this_checkouts_timers(tmp_path):
    pkg = tmp_path / "self_supervise_sfm_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text('WHERE = "other checkout"\n')
    (tmp_path / "chip_smoke.py").write_text(textwrap.dedent("""
        import os
        import sys

        import self_supervise_sfm_tpu_torch as pkg


        def _time_ms(fn):
            raise AssertionError("the other checkout's timer ran")


        _back_to_back_ms = _time_ms


        def main():
            print(pkg.WHERE, "|", _time_ms.__module__, _time_ms.__name__, "|",
                  _back_to_back_ms.__module__, _back_to_back_ms.__name__, "|",
                  os.getcwd(), "|", " ".join(sys.argv[1:]))
            return 7
    """))
    run = subprocess.run(
        [sys.executable, "-m", "self_supervise_sfm_tpu_torch.tools.retime_tree",
         str(tmp_path), "--kernels-only"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 7, run.stderr
    where, per_call, b2b, cwd, args = (s.strip() for s in run.stdout.split("|"))
    assert where == "other checkout"
    assert per_call == "self_supervise_sfm_tpu_torch.tools.timing per_call_ms"
    assert b2b == "self_supervise_sfm_tpu_torch.tools.timing back_to_back_ms"
    assert Path(cwd) == tmp_path
    assert args == "--kernels-only"
