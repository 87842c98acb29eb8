"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (`sdbench.faults`), the tiny CPU run of that
cell (past the look for a card) with the program patched, against the
committed limits."""

import pytest

from sdbench.faults import (altered_answers, half_batch_answers, half_batch_step,
                            state_unchanged)
from sdbench.tests.helpers import tiny_cell, tiny_run

FAULTS = [
    ("r34-infer-b32", altered_answers),
    ("r34-infer-b32", half_batch_answers),
    ("r34-train-b8", state_unchanged),
    ("r34-train-b8", half_batch_step),
    ("r50-train-b32", state_unchanged),
    ("r50-train-b32", half_batch_step),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with fault():
        r = tiny_run(tiny_cell(cell))
    assert r["correct"] is False, r["checks"]
