"""The capture guard of ``core/execache.py`` with stand-in objects (no
card): a :class:`GraphHold` dropped while a capture is open keeps its
graph, outputs and pool until the last open capture ends, whether the
hold dies by its last reference or in a garbage collection that starts on
the capturing thread, and whether one thread captures or two overlap.
Outside a capture a dropped hold releases at once."""
import gc
import threading
import weakref

import pytest

from repro_torch.core import execache as EC


class Witness:
    """Stands in for a graph (or its outputs): its deallocation is seen
    through a weak reference (a ``__del__`` would run in a collection's
    finalizer pass even for an object that the pass resurrects)."""

    def __init__(self, name, dead):
        self.name = name
        self._ref = weakref.ref(self, lambda _: dead.append(name))


def hold(name, dead):
    return EC.GraphHold(Witness(name, dead), Witness(name + ".out", dead),
                        ("pool", 1))


def test_outside_a_capture_a_dropped_hold_releases_at_once():
    dead = []
    h = hold("g", dead)
    del h
    assert sorted(dead) == ["g", "g.out"]
    assert EC.deferred_count() == 0 and not EC.capturing()


def test_a_hold_dropped_during_a_capture_releases_after_it():
    dead = []
    h = hold("g", dead)
    with EC.capture_guard():
        assert EC.capturing()
        del h
        assert dead == [] and EC.deferred_count() == 1
    assert sorted(dead) == ["g", "g.out"]
    assert EC.deferred_count() == 0 and not EC.capturing()


def test_a_collection_on_the_capturing_thread_defers_the_cycle():
    """An unreachable cycle that holds a graph (a daemon's plan, an
    engine), collected by a ``gc.collect`` inside the capture: nothing is
    destroyed until the capture ends."""
    dead = []

    class Owner:
        pass

    a, b = Owner(), Owner()
    a.peer, b.peer = b, a
    a.hold = hold("cycle", dead)
    del a, b
    with EC.capture_guard():
        gc.collect()
        # the hold's finalizer kept the graph and its outputs alive
        assert EC.deferred_count() == 1
        graph, refs = EC._DEFERRED[0]
        assert (graph.name, refs[0].name) == ("cycle", "cycle.out")
        alive = [weakref.ref(graph), weakref.ref(refs[0])]
        del graph, refs
        assert all(r() is not None for r in alive)
    assert [r() for r in alive] == [None, None]
    assert EC.deferred_count() == 0


def test_nested_guards_release_at_the_outermost_end():
    dead = []
    h = hold("g", dead)
    with EC.capture_guard():
        with EC.capture_guard():
            del h
        assert dead == []
    assert sorted(dead) == ["g", "g.out"]


def test_two_threads_capturing_at_once():
    """Thread A opens a capture, thread B opens one, a hold is dropped on
    a third thread; A ends first (the hold stays deferred: B still
    captures), then B ends and the hold is released."""
    dead = []
    holds = [hold("g", dead)]
    steps = {k: threading.Event() for k in
             ("a_in", "b_in", "a_go", "a_out", "b_go")}

    def capture(me, go, out):
        with EC.capture_guard():
            steps[me].set()
            assert steps[go].wait(10)
        if out:
            steps[out].set()

    ta = threading.Thread(target=capture, args=("a_in", "a_go", "a_out"))
    tb = threading.Thread(target=capture, args=("b_in", "b_go", None))
    ta.start()
    assert steps["a_in"].wait(10)
    tb.start()
    assert steps["b_in"].wait(10)
    dropper = threading.Thread(target=holds.clear)
    dropper.start()
    dropper.join(10)
    assert dead == [] and EC.deferred_count() == 1
    steps["a_go"].set()
    assert steps["a_out"].wait(10)
    ta.join(10)
    assert dead == [] and EC.capturing()
    steps["b_go"].set()
    tb.join(10)
    assert sorted(dead) == ["g", "g.out"]
    assert not EC.capturing() and EC.deferred_count() == 0


def test_a_failed_body_still_closes_the_guard():
    dead = []
    h = hold("g", dead)
    with pytest.raises(RuntimeError):
        with EC.capture_guard():
            del h
            raise RuntimeError("capture failed")
    assert sorted(dead) == ["g", "g.out"] and not EC.capturing()


def test_the_plan_and_the_serve_graph_keep_their_graphs_in_holds():
    """Both capture sites store their graph in a GraphHold (read back
    through the same attributes as before)."""
    import inspect

    from repro_torch.serving import engine as SE
    for fn in (EC._Plan.capture, SE.ServeGraph.capture):
        src = inspect.getsource(fn)
        assert "capture_guard()" in src and "GraphHold(" in src
