"""popsift_torch.parallel.ranks.run_ranks: the ranks' results by rank, a
failing or overrunning rank fails the call, and no process outlives it.

Each case starts two or three gloo ranks on the CPU.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_parallel_ranks as tpr  # noqa: E402
from popsift_torch.parallel.ranks import run_ranks  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _children() -> set:
    """The processes whose parent is this process, in any state."""
    me = str(os.getpid())
    kids = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:
            kids.add(int(d))
    return kids


def test_results_come_back_by_rank():
    before = _children()
    out = run_ranks(tpr.echo_rank, 3, "gloo", args=({"x": [1, 2]},),
                    timeout=120.0)
    assert out == [(r, 3, {"x": [1, 2]}) for r in range(3)]
    assert _children() <= before


def test_a_failing_rank_fails_the_call_at_once():
    before = _children()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed") as e:
        run_ranks(tpr.failing_rank, 3, "gloo", timeout=120.0)
    assert "KeyError: 'rank 1 fails'" in str(e.value)
    # the others were killed in their barrier, long before its timeout
    assert time.monotonic() - t0 < 60.0
    assert _children() <= before


def test_an_overrunning_rank_times_out_and_is_killed():
    before = _children()
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\] of 2"):
        run_ranks(tpr.sleeping_rank, 2, "gloo", args=(600.0,), timeout=5.0)
    assert _children() <= before


def test_a_function_of_the_main_script_runs_and_no_process_is_left(
        tmp_path):
    """As chip_smoke.py runs a rank body of its own: the ranks load the
    script under another name, and once the script has ended nothing it
    started is still running (the script checks its own children, the
    test its session)."""
    script = tmp_path / "main_script.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {str(REPO)!r})
        from popsift_torch.parallel.ranks import run_ranks

        def body(rank, x):
            return (__name__, rank * x)

        if __name__ == "__main__":
            print(run_ranks(body, 2, "gloo", args=(7,), timeout=120.0))
            me = str(os.getpid())
            kids = [d for d in os.listdir("/proc") if d.isdigit()
                    and open(f"/proc/{{d}}/stat").read()
                    .rsplit(")", 1)[1].split()[1] == me]
            print("children", kids)
    """))
    proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0
    assert "[('__mp_main__', 0), ('__mp_main__', 7)]" in out
    assert "children []" in out
    left = subprocess.run(["ps", "-o", "pid=", "-s", str(proc.pid)],
                          capture_output=True, text=True).stdout.split()
    assert left == []
