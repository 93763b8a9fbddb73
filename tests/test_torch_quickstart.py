"""The port's quickstart (``examples/quickstart_torch.py``) runs on the CPU.

Its ``main`` walks the twelve steps of ``examples/quickstart.py`` on the
port's backends (``host``, ``torch``, ``cuda``, ``serve``) at its own size
(1,000 objects) with ``device="cpu"``, where each kernel's plain version
runs.  Every parity assert inside it must hold (hits and visits across
backends, k-NN ids, the live, durable and moving-object paths, the front
end's answers against the direct index call), and step 12 must return the
streamed sweep's launch report and write its trace where it is told.

Tolerance: exact (the quickstart's own asserts).
"""
import importlib.util
import json
import os

import pytest

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "quickstart_torch.py")


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_every_step_on_the_cpu(quickstart, tmp_path, capsys):
    trace = tmp_path / "trace.json"
    rep = quickstart.main("cpu", trace_out=str(trace))
    out = capsys.readouterr().out
    for step in ("backend=serve  identical hits", "knn(k=5) over 8 points",
                 "recover(): snapshot + 5 WAL ops", "pair set identical",
                 "serving front end:", "observability:"):
        assert step in out
    # step 12: the streamed sweep's ledger, in the card's bytes
    assert rep.kind == "float32" and rep.stream and rep.queries == 20
    assert 0 < rep.tiles_fetched < rep.tiles_total and rep.bytes_streamed > 0
    assert "traceEvents" in json.loads(trace.read_text())


def test_quickstart_entry_point_needs_a_card_or_the_cpu(quickstart, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        quickstart.main(None)
