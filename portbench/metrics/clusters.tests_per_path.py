"""Primitive and node tests per path: the growth of
``Session.num_bvh_hits`` over the window over the paths traced in it
(program counter)."""


def read(obs):
    paths = obs.counters.get("paths", 0)
    hits = obs.counters.get("bvh_hits", 0)
    return hits / paths if paths and hits else None
