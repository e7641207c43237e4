"""The reader of ``queue.graph_replay_share`` on synthetic profiled
slices: the ``wpt/queue.iter`` spans that hold a ``wpt/queue.replay``
span, over all ``wpt/queue.iter`` spans; None where no iteration
replayed (a program without the graph, or a run on the CPU)."""

from __future__ import annotations

from conftest import PORTBENCH

MS = 1_000_000      # ns


def share(host):
    from portbench import harness
    p = harness.Profile(device_ops=[], host_events=[(n, s * MS, e * MS) for n, s, e in host],
                        wall_s=0.1, launched={}, calls={}, units=1)
    obs = harness.Observed(config={}, counters={}, host={}, profile=p)
    return harness.load_module(PORTBENCH / "metrics" / "queue.graph_replay_share.py").read(obs)


# one batch: an eager iteration, the capture, then two replays
BATCH = [("wpt/queue", 0, 100), ("wpt/sync.queue_alive", 0, 2),
         ("wpt/queue.iter", 2, 30), ("wpt/trace", 3, 10), ("wpt/regen", 20, 29),
         ("wpt/sync.queue_alive", 30, 32), ("wpt/queue.capture", 32, 60),
         ("wpt/trace", 33, 40), ("wpt/regen", 50, 59),
         ("wpt/queue.iter", 60, 70), ("wpt/queue.replay", 61, 69),
         ("wpt/sync.queue_alive", 70, 72),
         ("wpt/queue.iter", 72, 82), ("wpt/queue.replay", 73, 81),
         ("wpt/sync.queue_alive", 82, 84)]


def test_two_replays_of_three_iterations():
    assert share(BATCH) == 2 / 3


def test_silent_without_a_replay():
    eager = [h for h in BATCH if h[0] not in ("wpt/queue.replay", "wpt/queue.capture")]
    assert share(eager) is None
    assert share([]) is None
    # a replay span outside any iteration is not an iteration's
    assert share([("wpt/queue.iter", 0, 10), ("wpt/queue.replay", 20, 30)]) is None
