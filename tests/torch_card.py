"""A card's graph rule emulated on the CPU, for the tests of the port's
CUDA-graph replayer (``semantic_suma_tpu_torch/graphs.py``) and of its two
owners, the odometry step's stages and the segmenter's network.

:func:`emulate_card` makes ``graphs.decide`` judge as on a card, starts the
process's seen set afresh, and replaces the capture (``graphs.capture``) by
a :class:`StandIn`. A capture records a call that the replay right after it
runs; the stand-in's capture runs the call (its input buffers hold the
call's inputs) and its first replay does nothing. A later replay runs the
body again, writing into what the capture returned, and takes back the
Python counters the run bumped, as a replay runs no Python: the replayer
adds the capture's, as on a card."""
from semantic_suma_tpu_torch import graphs


class StandIn:
    """A "graph" that reruns the captured body."""

    def __init__(self, body):
        self.body, self.ran = body, True
        self.out = body()

    def replay(self):
        if self.ran:   # the capture's run was this call's
            self.ran = False
            return
        before = graphs.counter_values()
        out = self.body()
        graphs.counter_add(graphs.counter_delta(before,
                                                graphs.counter_values()), -1)
        if self.out is not None:
            self.out.copy_(out)

    def pool(self):
        return None


def _capture(pool, device, body):
    graph = StandIn(body)
    return graph, graph.out


def emulate_card(monkeypatch) -> None:
    decide = graphs.decide
    monkeypatch.setattr(graphs, "decide",
                        lambda **kw: decide(**{**kw, "device_type": "cuda"}))
    monkeypatch.setattr(graphs, "capture", _capture)
    monkeypatch.setattr(graphs, "_SEEN", set())
