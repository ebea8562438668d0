"""The port's research loops on the CPU (``vae2_tpu_torch/tools/``
``northstar_loop``, ``seg_trajectory``, ``ablate_flagship``) against the JAX
package's tools that they port.

Each tool runs for real, as a subprocess with ``--device cpu`` (all
three at once, two OpenMP threads each): the north-star loop one-shot on
the tiny recipe over 8 synthetic 64x32 videos (the epoch-0 init and 4
epochs of three steps at lambda 1: exit 0 needs x2 L1 down and MS-SSIM
up), the seg trajectory on the tiny seg recipe, and the control arm of the
ablation grid for one epoch. The JAX tools run in-process with
``subprocess.run`` faked (their stages recorded, their files and outputs
made up), so that each stage's KEY VALUE overrides and flags can be held
to the port's with the paths and suffixes translated (``tools/train.py``
-> ``-m vae2_tpu_torch.tools.train``, ``.msgpack`` -> ``.pt``, the output
directories, the added ``--device``). The north-star loop's per-epoch mode
on a run that cannot improve (TRAIN.LR 0, one row: the first row is the
last) runs on both sides with the same faked stages: both exit non-zero.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from vae2_tpu_torch.tools import ablate_flagship, northstar_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = "experiments/cityscapes/debug_tiny_32x64.yaml"
SEG_CFG = "experiments/cityscapes/debug_seg_tiny_32x64.yaml"
SEG_DATA = "data/synthetic_seg"
NS_ONE_SHOT = ["--one-shot", "--epochs", "4", "--eval-points", "1",
               "--num-samples", "8", "--eval-clips", "2"]
# what makes the tiny recipe learn in 12 steps: lambda 1 (the flagship's
# fix) and a larger lr (at the recipe's 0.1 and 1e-3 its eval x2 L1 did
# not move in 2 epochs, as in the JAX tool's docs/northstar_tiny.json)
NS_LEARNS = ["TRAIN.X2RECON_LAMBDA", "1.0", "TRAIN.BATCH_SIZE_PER_GPU", "2",
             "TRAIN.LR", "0.003"]
NS_NO_GAIN = ["--epochs", "1", "--no-eval-epoch0", "--num-samples", "8",
              "--eval-clips", "2"]
STAGE_OPTS = ["GPU.DTYPE", "float32", "WORKERS", "1"]


def jax_tool(name):
    """tools/<name>.py as a module (it imports tools/_init_paths.py)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return mod


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """The three port drives, run at once; {name: (rc, output, root)}."""
    root = tmp_path_factory.mktemp("loops")
    data = str(root / "data")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "gen_synthetic_data.py"),
                    "--out", data, "--num-videos", "8", "--width", "64",
                    "--height", "32"], check=True, capture_output=True)
    log = ["LOG_DIR", str(root / "log")]
    ns = ["--device", "cpu", "--cfg", TINY_CFG, "--data", data]
    runs = {
        "ns_one_shot": ("northstar_loop", [
            *ns, *NS_ONE_SHOT, "--out", str(root / "ns1"),
            "--trajectory-out", str(root / "ns1.json"), *log, *STAGE_OPTS,
            *NS_LEARNS]),
        "seg": ("seg_trajectory", [
            "--device", "cpu", "--out", str(root / "seg"), "--trajectory-out",
            str(root / "seg.json"), *log, "GPU.DTYPE", "float32"]),
        "ablate": ("ablate_flagship", [
            "--device", "cpu", "--cfg", TINY_CFG, "--data", data,
            "--epochs", "1", "--width", "64", "--height", "32",
            "--only", "control_lam0.1", "--out", str(root / "abl.json"),
            "--out-root", str(root), *log, *STAGE_OPTS, "PRINT_FREQ", "1"]),
    }
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", f"vae2_tpu_torch.tools.{tool}", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k, (tool, argv) in runs.items()}
    out = {k: (p.wait(), p.stdout.read(), root) for k, p in procs.items()}
    return out, data


def _port_stages(output):
    """The stage commands a port tool printed ('+ cmd')."""
    return [line[2:].split() for line in output.splitlines()
            if line.startswith("+ ")]


def _fake_run(calls, final_dir, values):
    """A subprocess.run for the JAX tools: records each command and makes
    up what the next stage reads."""
    def run(cmd, cwd=None, **kw):
        cmd = list(cmd)
        calls.append(cmd)
        script = _split(cmd)[0] + ".py"
        suffix = ".pt" if cmd[1] == "-m" else ".msgpack"  # port or JAX
        kv = dict(zip(cmd[::2], cmd[1::2])) | dict(zip(cmd[1::2], cmd[2::2]))
        stdout = ""
        if script in ("train.py", "train_seg.py"):
            os.makedirs(final_dir, exist_ok=True)
            end = int(kv["TRAIN.END_EPOCH"])
            names = ["model_final_state", "seg_final_state"]
            if end:
                names.append("checkpoint")
            snap = int(kv.get("TRAIN.SNAPSHOT_EVERY", 0))
            names += [f"checkpoint_epoch{e:04d}"
                      for e in range(snap, end + 1, snap or end + 1)]
            for n in names:
                open(os.path.join(final_dir, n + suffix), "w").close()
            values["epoch"] = end
        elif script == "inference.py":
            ckpts = kv.get("--checkpoint", "").split(",")
            for c in ckpts:
                e = (int(c.split("epoch")[-1].split(".")[0])
                     if "checkpoint_epoch" in c else values["epoch"])
                os.makedirs(os.path.join(final_dir, "vis", f"epoch{e}"),
                            exist_ok=True)
        elif script == "statistic.py":
            values["l1"] -= 1.0
            with open(kv["--out"], "w") as f:
                json.dump({"1_reconloss": [values["l1"], 0.0],
                           "1_msssimloss": [1.0 / values["l1"], 0.0],
                           "1_psnrloss": [1.0, 0.0]}, f)
        elif script == "fid_score.py":
            stdout = "FID:  1.0\n"
        elif script == "inception_score.py":
            stdout = "IS: 1.0 +/- 0.0\n"
        elif script == "test.py":
            stdout = "MeanIU: 0.5, Pixel_Acc: 0.5, Mean_Acc: 0.5\n"
        return subprocess.CompletedProcess(cmd, 0, stdout=stdout, stderr="")
    return run


def _jax_stages(monkeypatch, name, argv, final_dir, tool=None):
    """Run the JAX tool ``name`` (or ``tool``, a module with the same
    ``main``) with faked stages; returns (commands, its exit code, its
    module)."""
    tool = tool or jax_tool(name)
    calls = []
    monkeypatch.setattr(tool.subprocess, "run",
                        _fake_run(calls, final_dir, {"l1": 100.0,
                                                     "epoch": 0}))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    rc = 0
    try:
        tool.main()
    except SystemExit as e:
        rc = 1 if e.code else 0
    monkeypatch.undo()
    return calls, rc, tool


def _split(cmd):
    """(stage, flags, KEY VALUE pairs) of a stage command of either side,
    without the port's ``--device``."""
    if "--device" in cmd:
        i = cmd.index("--device")
        cmd = cmd[:i] + cmd[i + 2:]
    if cmd[1] == "-m":
        stage, rest = cmd[2].rsplit(".", 1)[-1], cmd[3:]
    else:
        stage, rest = os.path.basename(cmd[1]).split(".")[0], cmd[2:]
    i = 0
    while i < len(rest) and rest[i].startswith("--"):
        i += 2
    return stage, dict(zip(rest[:i:2], rest[1:i:2])), rest[i:]


def _translated(cmd, jax_root, port_root):
    return [a.replace(".msgpack", ".pt").replace(jax_root, port_root)
            for a in cmd]


def _same_stages(port_cmds, jax_cmds, jax_root, port_root, stages):
    got = [_split(c) for c in port_cmds if _split(c)[0] in stages]
    want = [_split(_translated(c, jax_root, port_root)) for c in jax_cmds
            if _split(c)[0] in stages]
    assert got == want


def test_northstar_stages_and_schema_match_the_jax_tool(drives, monkeypatch):
    runs, data = drives
    rc, output, root = runs["ns_one_shot"]
    jax_out = str(root / "jax_ns")
    argv = ["--cfg", TINY_CFG, "--data", data, *NS_ONE_SHOT, "--out",
            jax_out, "--trajectory-out", str(root / "ns_jax.json"), "LOG_DIR",
            str(root / "log"), *STAGE_OPTS, *NS_LEARNS]
    final = os.path.join(jax_out, "cityscapessequence", "debug_tiny_32x64")
    calls, _, _ = _jax_stages(monkeypatch, "northstar_loop", argv, final)
    _same_stages(_port_stages(output), calls, jax_out, str(root / "ns1"),
                 ("train", "inference", "statistic"))
    assert rc == 0, output[-3000:]
    with open(root / "ns1.json") as f:
        rows = json.load(f)
    with open(root / "ns_jax.json") as f:
        want = json.load(f)
    assert [r["epoch"] for r in rows] == [0, 4]
    assert [list(r) for r in rows] == [list(r) for r in want]
    assert rows[1]["x2_l1"] < rows[0]["x2_l1"]
    for r in rows:
        assert r["fid_x2_random_inception"] >= 0.0
        assert r["is_x2_random_inception"] is not None


def test_northstar_run_that_cannot_improve_exits_nonzero(tmp_path,
                                                         monkeypatch):
    """The per-epoch mode, one row, TRAIN.LR 0: the port and the JAX tool,
    each with the same faked stages, run the same stages and exit
    non-zero."""
    data = os.path.join(REPO, "data", "synthetic64")
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        argv = ["--cfg", TINY_CFG, "--data", data, *NS_NO_GAIN, "--out",
                root, *(["--device", "cpu"] if side == "port" else []),
                "LOG_DIR", str(tmp_path / "log"), *STAGE_OPTS, "TRAIN.LR",
                "0.0"]
        final = os.path.join(root, "cityscapessequence", "debug_tiny_32x64")
        out[side] = _jax_stages(
            monkeypatch, "northstar_loop", argv, final,
            tool=northstar_loop if side == "port" else None)
    assert out["port"][1] != 0 and out["jax"][1] != 0
    assert [_split(c)[0] for c in out["port"][0]] == [
        "train", "inference", "statistic", "statistic", "statistic",
        "fid_score", "inception_score"]
    _same_stages(out["port"][0], out["jax"][0], str(tmp_path / "jax"),
                 str(tmp_path / "port"),
                 ("train", "inference", "statistic", "fid_score",
                  "inception_score"))


def test_seg_trajectory_matches_the_jax_tool(drives, monkeypatch):
    runs, _ = drives
    rc, output, root = runs["seg"]
    assert rc == 0, output[-3000:]
    with open(root / "seg.json") as f:
        rows = json.load(f)
    assert [list(r) for r in rows] == [["epochs", "mean_iu", "pixel_acc",
                                        "mean_acc"]] * 2
    assert rows[1]["mean_iu"] > rows[0]["mean_iu"]
    jax_out = str(root / "jax_seg")
    final = os.path.join(jax_out, "cityscapes", "debug_seg_tiny_32x64")
    calls, jax_rc, _ = _jax_stages(
        monkeypatch, "seg_trajectory", ["--out", jax_out, "--trajectory-out",
                                        str(root / "seg_jax.json")], final)
    assert jax_rc == 1  # the fake's scores do not improve
    port = [c for c in _port_stages(output)]
    # the port forwards its extra options to both stages, after the JAX ones
    extra = ["LOG_DIR", str(root / "log"), "GPU.DTYPE", "float32"]
    for c in port:
        i = c.index("LOG_DIR")
        del c[i:i + len(extra)]
    _same_stages(port, calls, jax_out, str(root / "seg"),
                 ("train_seg", "test"))


def test_ablation_grid_and_control_arm(drives, monkeypatch):
    """The grid is the JAX tool's but for the control arm, which sets
    lambda 0.1 where the JAX tool (on a recipe that now carries 1.0) sets
    nothing; the arm's train command is the JAX tool's otherwise; the CPU
    arm yields parsed rows."""
    jax = jax_tool("ablate_flagship")
    assert list(ablate_flagship.ABLATIONS) == list(jax.ABLATIONS)
    for name, opts in jax.ABLATIONS.items():
        if name == "control_lam0.1":
            assert opts == [] and ablate_flagship.ABLATIONS[name] == [
                "TRAIN.X2RECON_LAMBDA", "0.1"]
        else:
            assert ablate_flagship.ABLATIONS[name] == opts, name
    assert ablate_flagship.LOG_RE.pattern == jax.LOG_RE.pattern

    runs, data = drives
    rc, output, root = runs["ablate"]
    assert rc == 0, output[-3000:]
    with open(root / "abl.json") as f:
        result = json.load(f)
    assert list(result) == ["control_lam0.1"]
    assert result["control_lam0.1"]["rows"], output[-3000:]
    assert "X2RECON_LAMBDA: 0.1" in output

    # the JAX tool reads its arm's log directory under the repo root
    arm_dir = os.path.join(REPO, "output_ablate_x2lam1")
    made = not os.path.exists(arm_dir)
    os.makedirs(os.path.join(arm_dir, "cityscapessequence",
                             "northstar_flagship_128x256"), exist_ok=True)
    try:
        calls, _, _ = _jax_stages(monkeypatch, "ablate_flagship", [
            "--only", "x2lam1", "--out", ""], str(root / "jax_ablate"))
    finally:
        if made:
            shutil.rmtree(arm_dir)
    args = ablate_flagship.parse_args(["--only", "x2lam1", "--device", "cpu"])
    got = _split(ablate_flagship.train_cmd(args, "x2lam1"))
    want = _split(calls[0])
    assert got == want
