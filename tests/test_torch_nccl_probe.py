"""The NCCL probe's launcher (``eval/nccl_probe.py``) on the CPU: over 2 gloo
ranks it prints one parsable line a setting; a run whose ranks hang is
killed whole at its time limit and still gives its line; NCCL's debug
lines are read into transports, NVLS lines and warnings."""
import json
import os
import re
import sys
import time

import pytest

from relightableavatar_tpu_torch.eval import nccl_probe

LINE = re.compile(r"^\[nccl-probe\] (\{.*\})$", re.M)
ALL_OPS = [p + op for p in ("", "own/") for op in nccl_probe.OPS]
# a rank that reports its first collective, then hangs
HUNG_RANK = '''import json, os, sys, time
rank = int(os.environ["RANK"])
with open(os.path.join(os.environ["HUNG_DIR"], f"pid{rank}"), "w") as f:
    f.write(str(os.getpid()))
sys.stdout.write("[nccl-probe-rank] " + json.dumps(dict(
    rank=rank, world=2, nccl=None, done=["barrier"], wrong=[], ms={"barrier": 1.0},
    bytes={"barrier": 0})) + "\\n")
sys.stdout.flush()
time.sleep(600)
'''


def _lines(out: str) -> list:
    return [json.loads(m) for m in LINE.findall(out)]


def _gone(pid: int, wait_s: float = 10.0) -> bool:
    """Whether ``pid`` has exited (a zombie counts) within ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.2)
    return False


def test_launcher_prints_one_line_a_setting_over_gloo(capsys):
    rc = nccl_probe.main(["--backend", "gloo", "--nproc", "2", "--settings", "default"])
    lines = _lines(capsys.readouterr().out)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert line["setting"] == "default" and line["env"] == {} and line["world"] == 2
    assert line["ok"] and line["rc"] == 0 and not line["killed"] and not line["wrong"]
    assert line["completed"] == ALL_OPS and line["done_by_rank"] == {"0": 12, "1": 12}
    assert set(line["ms"]) == set(ALL_OPS) and all(v > 0 for v in line["ms"].values())
    assert line["bytes"]["all_reduce"] == nccl_probe.GRAD_BYTES
    assert line["bytes"]["all_gather"] == nccl_probe.MAPS_BYTES // 2
    assert line["bytes"]["all_gather_map"] == nccl_probe.MAP_BYTES // 2
    assert line["bytes"]["all_reduce_scalar"] == 4


def test_a_hung_run_is_killed_whole(tmp_path, monkeypatch, capsys):
    """Ranks that hang after their first collective: the launcher kills the
    torchrun session at its time limit, every rank process is gone, and the
    setting's line says how far the ranks got."""
    (tmp_path / "hung_rank.py").write_text(HUNG_RANK)
    monkeypatch.setattr(nccl_probe, "MODULE", "hung_rank")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("HUNG_DIR", str(tmp_path))
    t0 = time.monotonic()
    rc = nccl_probe.main(["--backend", "gloo", "--nproc", "2", "--settings", "p2p_off",
                          "--timeout", "20"])
    took = time.monotonic() - t0
    lines = _lines(capsys.readouterr().out)
    assert rc == 1 and len(lines) == 1 and took < 40, took
    line = lines[0]
    assert line["setting"] == "p2p_off" and line["env"] == {"NCCL_P2P_DISABLE": "1"}
    assert line["killed"] and line["rc"] is None and not line["ok"]
    assert line["completed"] == ["barrier"] and line["done_by_rank"] == {"0": 1, "1": 1}
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert all(_gone(p) for p in pids), pids


def test_smoke_run_cli_kills_a_hung_torchrun(tmp_path, monkeypatch):
    """``chip_smoke.run_cli`` past its limit on a torchrun whose ranks hang:
    it fails naming the limit and the ranks' progress lines, and no rank
    is left running."""
    import chip_smoke
    (tmp_path / "hung_rank.py").write_text(HUNG_RANK)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("HUNG_DIR", str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ran past 20 s:\n\[nccl-probe-rank\] ") as e:
        chip_smoke.run_cli(["torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                            "-m", "hung_rank"], timeout=20, cwd=str(tmp_path))
    assert time.monotonic() - t0 < 40 and str(e.value).count("[nccl-probe-rank]") >= 2
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert all(_gone(p) for p in pids), pids


@pytest.mark.parametrize("own_session", [False, True])
def test_run_session_kills_every_process_it_started(tmp_path, own_session):
    """A command with a hung child, in its session or (as torchrun starts
    its workers) in a session of its own: both go at the limit."""
    child = tmp_path / "child"
    code = ("import subprocess, sys, time; "
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'], "
            f"start_new_session={own_session}); "
            f"open({str(child)!r}, 'w').write(str(p.pid)); time.sleep(600)")
    run = nccl_probe.run_session([sys.executable, "-c", code], dict(os.environ), 5)
    assert run["killed"] and run["rc"] is None and run["seconds"] < 20
    assert _gone(int(child.read_text()))


def test_read_nccl_logs(tmp_path):
    (tmp_path / "default.h.1.log").write_text(
        "h:1:2 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read\n"
        "h:1:2 [0] NCCL INFO Channel 01/0 : 0[0] -> 1[1] via P2P/CUMEM/read\n"
        "h:1:2 [0] NCCL INFO NVLS multicast support is not available on dev 0\n")
    (tmp_path / "default.h.2.log").write_text(
        "h:2:3 [1] NCCL INFO Channel 00/0 : 1[1] -> 0[0] via SHM/direct/direct\n"
        "h:2:3 [1] NCCL INFO Channel 00/0 : 1[1] -> 2[2] [send] via NET/Socket/0\n"
        "h:2:3 [1] misc/socket.cc:49 NCCL WARN socketProgressOpt: abort called\n"
        "h:2:3 [1] misc/socket.cc:49 NCCL WARN socketProgressOpt: abort called\n")
    got = nccl_probe.read_nccl_logs([str(p) for p in tmp_path.iterdir()])
    assert got == dict(transports={"0->1": ["P2P/CUMEM/read"], "1->0": ["SHM/direct/direct"],
                                   "1->2": ["NET/Socket/0"]},
                       nvls=["NVLS multicast support is not available on dev 0"],
                       warnings=["socketProgressOpt: abort called"])
