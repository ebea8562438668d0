"""The port's two-host rehearsal (``vae2_tpu_torch/tools/multihost_rehearsal.py``)
on the CPU: two ``torch.distributed.run`` launchers of one gloo rank each,
joined by a static rendezvous on the loopback, run one adversarial step of
the tiny spec (at 16x32) on their hosts' slices of a global batch of 8, and
rank 0 holds it against one process on the whole batch with
``ddp_check``'s bounds. With the planted fault (each worker's rank taken from LOCAL_RANK:
both hosts load shard 0) the rehearsal must fail, and on the step's values,
not on its layout checks.
"""

import json

from vae2_tpu_torch.tools import multihost_rehearsal as mh

# the tiny spec at 16x32 without remat: a third of the all-reduces, each a
# host round trip between the ranks
SMALL = ["TRAIN.IMAGE_SIZE", "[32, 16]", "TPU.REMAT", "none"]


def _run(tmp_path, fault, capfd, monkeypatch):
    # two threads a rank: the test suite's other workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    argv = ["--device", "cpu", "--workdir", str(tmp_path), "--fault", fault,
            *SMALL]
    try:
        verdict = mh.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
        verdict = json.loads((tmp_path / "verdict.json").read_text())
    return rc, verdict, capfd.readouterr().out


def test_two_hosts_match_one_process(tmp_path, capfd, monkeypatch):
    rc, verdict, out = _run(tmp_path, "none", capfd, monkeypatch)
    assert rc == 0 and verdict["failed"] == [], verdict
    assert "multihost rehearsal PASSED" in out
    assert "[rank 1 of 2, host 1, local rank 0] on cpu, data shard 1" in out
    assert verdict["ranks_bitwise_equal"]
    assert (verdict["all_reduces_per_rank"]
            == [verdict["all_reduces_from_model"]] * 2)
    assert verdict["host_exit_codes"] == [0, 0]
    assert verdict["shards"] == [0, 1] and verdict["devices"] == ["cpu"] * 2


def test_rank_from_local_rank_is_caught(tmp_path, capfd, monkeypatch):
    rc, verdict, out = _run(tmp_path, "local_rank", capfd, monkeypatch)
    print(json.dumps(verdict))
    assert rc != 0 and "multihost rehearsal PASSED" not in out
    assert verdict["shards"] == [0, 0]
    assert any(f.startswith("loss ") for f in verdict["failed"]), verdict
    assert verdict["ranks_bitwise_equal"]  # the fault keeps the ranks alike
