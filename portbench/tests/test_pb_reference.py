"""The frozen plain reference against the program's CPU path (the plain
versions of its kernels) at tiny Dims: in the configuration's own dtype
the two are the same arithmetic, so they agree bit for bit; in float64
the reference stays within the output check's limits of the float32
program."""
import copy

import pytest
import torch

from portbench import harness
from portbench.control import one_job

TINY = {"n_groups": 6, "n_features": 10, "ng_rows": 32, "nf_rows": 64}


def tiny_cell(workload, batch, frames, seed=4):
    import importlib
    _, spec, traffic, _ = harness.cell_files(workload)
    spec = copy.deepcopy(spec)
    spec["dims"] = dict(TINY)
    entry = importlib.import_module(f"portbench.entries.{spec['entry']}")
    ref = importlib.import_module(f"portbench.refs.{spec['entry']}")
    cell = entry.Cell(spec, traffic, seed, "cpu", batch=batch,
                      frames=frames)
    return spec, traffic, cell, ref


@pytest.mark.parametrize("workload,frames", [("pcw_sqrt.montecarlo", 12)])
def test_reference_equals_the_cpu_path(workload, frames):
    torch.manual_seed(0)
    spec, traffic, cell, ref = tiny_cell(workload, 3, frames)
    jobs = one_job(cell, "cpu")
    got, (fields, g0, a0) = harness.sampled(cell, traffic, jobs, 4)
    want = ref.run(spec, fields, g0, a0, dtype="float32", device="cpu")
    for k, v in got[0].items():
        assert torch.equal(v, want[k]), k
    want64 = ref.run(spec, fields, g0, a0, dtype="float64", device="cpu")
    numbers, ok, (pos, rot) = harness.compare(got, want64,
                                              traffic["check"])
    assert ok, numbers
    assert numbers["rows_off_pct"][0] == 0
    assert 0 < float(pos.max()) < 1e-5 and 0 < float(rot.max()) < 1e-6
