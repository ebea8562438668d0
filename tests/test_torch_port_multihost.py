"""The port's two-host rehearsal (``vae2_tpu_torch/tools/multihost_rehearsal.py``)
on the CPU: two ``torch.distributed.run`` launchers of gloo ranks, joined
by a static rendezvous on the loopback, run one adversarial step of the
tiny spec on their shards of a global batch of 8 made of the hosts'
slices, and rank 0 holds it against one process on the whole batch with
``ddp_check``'s bounds and two controls (the one-ulp move of the clips,
and the BN statistics reduced in the ranks' blocks). Two hosts of two
ranks at the tiny spec's 32x64 with REMAT 'stage': the layout whose
d_frame gradient once left its bound (2.9e-4 from one process, its one-ulp
control 4.2e-5: the statistics reduced as a mean of four ranks' means).
Two hosts of one rank under TPU.MESH.SPATIAL 2 (16x32): one spatial group
across the hosts, halo exchanges counted. With the planted fault (each
worker's rank taken from LOCAL_RANK: both hosts load shard 0) the
rehearsal must fail, and on the step's values, not on its layout checks.
"""

import json

from vae2_tpu_torch.tools import multihost_rehearsal as mh

# the tiny spec at 16x32 without remat: a third of the all-reduces, each a
# host round trip between the ranks
SMALL = ["TRAIN.IMAGE_SIZE", "[32, 16]", "TPU.REMAT", "none"]


def _run(tmp_path, fault, capfd, monkeypatch, argv=SMALL):
    # one thread a rank: the test suite's other workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--device", "cpu", "--workdir", str(tmp_path), "--fault", fault,
            *argv]
    try:
        verdict = mh.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
        verdict = json.loads((tmp_path / "verdict.json").read_text())
    return rc, verdict, capfd.readouterr().out


def test_two_hosts_match_one_process(tmp_path, capfd, monkeypatch):
    """Two hosts of two ranks each (2x2), at the tiny spec's own size."""
    rc, verdict, out = _run(tmp_path, "none", capfd, monkeypatch,
                            ["--nproc-per-host", "2"])
    print(json.dumps(verdict))
    assert rc == 0 and verdict["failed"] == [], verdict
    assert "multihost rehearsal PASSED" in out
    assert "[rank 3 of 4, host 1, local rank 1] on cpu, data shard 3" in out
    assert verdict["ranks_bitwise_equal"]
    assert (verdict["all_reduces_per_rank"]
            == [verdict["all_reduces_from_model"]] * 4)
    assert verdict["host_exit_codes"] == [0, 0]
    assert verdict["shards"] == [0, 1, 2, 3]
    assert verdict["devices"] == ["cpu"] * 4


def test_two_hosts_split_one_image(tmp_path, capfd, monkeypatch):
    """Two hosts of one rank under TPU.MESH.SPATIAL 2: both ranks hold the
    same clips (data shard 0), each its 8 of the 16 rows, and exchange halo
    rows across the hosts."""
    rc, verdict, out = _run(tmp_path, "none", capfd, monkeypatch,
                            [*SMALL, "TPU.MESH.SPATIAL", "2"])
    assert rc == 0 and verdict["failed"] == [], verdict
    assert verdict["spatial"] == 2 and verdict["shards"] == [0, 0]
    assert verdict["halo_exchanges_from_model"] > 0
    assert (verdict["halo_exchanges_per_rank"]
            == [verdict["halo_exchanges_from_model"]] * 2)


def test_rank_from_local_rank_is_caught(tmp_path, capfd, monkeypatch):
    rc, verdict, out = _run(tmp_path, "local_rank", capfd, monkeypatch)
    print(json.dumps(verdict))
    assert rc != 0 and "multihost rehearsal PASSED" not in out
    assert verdict["shards"] == [0, 0]
    assert any(f.startswith("loss ") for f in verdict["failed"]), verdict
    assert verdict["ranks_bitwise_equal"]  # the fault keeps the ranks alike
