"""Share of the profiled frames' queue iterations that ran as one replay
of the captured iteration graph: the port's ``wpt/queue.replay`` spans
inside its ``wpt/queue.iter`` spans, over the ``wpt/queue.iter`` spans
(program span).  Every iteration but each loop's first replays, so about
0.95 at ~23 iterations a batch.  None where no iteration replayed: a
program without the graph, or a run on the CPU."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    its = spans.select(sp, "queue.iter")
    replays = spans.select(sp, "queue.replay", inside="queue.iter")
    return len(replays) / len(its) if its and replays else None
