"""Concurrency/race coverage — the aux layer the reference covers with one
mutex (SURVEY §5): CellStore under concurrent producers/consumers, and
independent Trigger instances on separate threads sharing one store."""

import threading

import numpy as np

from ltetrigger_jax.runtime.cellstore import Cell, CellStore


def _mkcell(i):
    return Cell(cell_id=i, nof_tx_ports=1, cp_len="Normal", nof_prb=6,
                phich_len="Normal", nof_phich_resources="1", sfn_offset=0)


def test_cellstore_concurrent_track_drop():
    store = CellStore()
    n = 2000

    def producer(base):
        for i in range(n):
            store.track_cell(_mkcell(base + i))

    def dropper():
        dropped = 0
        while dropped < n:
            c = store.latest_cell()
            if c is not None:
                store.drop_cell(c)
                dropped += 1

    threads = [threading.Thread(target=producer, args=(0,)),
               threading.Thread(target=producer, args=(10000,)),
               threading.Thread(target=dropper)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # 2n tracked, n dropped
    assert len(store.cells()) == n
    assert store.tracking()


def test_cellstore_query_during_mutation():
    store = CellStore()
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                store.cells()
                store.tracking()
                store.latest_cell()
        except Exception as e:       # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    for i in range(5000):
        store.track_cell(_mkcell(i))
        if i % 3 == 0:
            store.drop_cell_id(i)
    stop.set()
    t.join(timeout=30)
    assert not errors


def test_parallel_triggers_one_store():
    """Two Trigger pipelines (separate threads, e.g. two antennas) feeding
    one shared CellStore."""
    from ltetrigger_jax.models import api
    from tests.conftest import load_frame

    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 6)
    store = CellStore()
    results = []

    def worker():
        t = api.Trigger(psr_threshold=4, cellstore=store)
        # pipelined event delivery: flush() forces pending events out
        # (class docstring contract)
        results.append(t.process(sig) + t.flush())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 2
    assert all(r and r[0].cell_id == cell_id for r in results)
    assert len(store.cells()) == 2
