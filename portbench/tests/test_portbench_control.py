"""The control of each cell at a small size on the CPU: the plain reference
computed one precision below the configuration's, put in the program's
place, must fail the cell's limits, while the program passes them.  The
readings that set the limits come from the same functions at the cells'
own sizes on the card (`python3 portbench/control.py --workload <cell>`)."""

import json
import os

import pytest

from portbench.kinds import outer, search, solve

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits(workload):
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as fh:
        return json.load(fh)


def cell(config_name, traffic_name, **config):
    with open(os.path.join(HERE, "configs", f"{config_name}.json")) as fh:
        base = json.load(fh)
    with open(os.path.join(HERE, "traffic", f"{traffic_name}.json")) as fh:
        traffic = json.load(fh)
    return {**base, **config}, traffic


def test_search_control_fails_and_the_program_passes():
    config, traffic = cell("poisson2d_511", "search", min_level=2, max_level=6)
    traffic = {**traffic, "order": [0, 3, 9, 12, 15, 31], "check_trees": 6}
    rows = list(search.control(config, traffic, [1, 2, 3], "cpu"))
    bound = limits("poisson2d_511.search")
    for row in rows[-3:]:
        assert row["program"][0] <= bound["rho_gap"] and row["program"][1] <= bound[
            "iteration_gap"]
        assert row["control"][0] > bound["rho_gap"] or row["control"][1] > bound[
            "iteration_gap"]


def test_solve_control_fails():
    config, traffic = cell("poisson2d_511", "solve", min_level=2, max_level=6)
    bound = limits("poisson2d_511.solve")["residual"]
    for row in solve.control(config, traffic, [1, 2, 3], "cpu"):
        assert row["control"] > bound


@pytest.mark.parametrize("candidate", [0, 9])
def test_outer_control_fails_and_the_program_passes(candidate):
    config, traffic = cell("helmholtz2d_127", "outer", min_level=1, max_level=5, k=20.0)
    traffic = {**traffic, "candidates": [traffic["candidates"][candidate]]}
    bound = limits("helmholtz2d_127.outer")
    (row,) = list(outer.control(config, traffic, [1], "cpu"))
    assert row["program_gaps"][0] <= bound["outer_iteration_gap"]
    assert row["program_gaps"][1] <= bound["outer_rho_gap"]
    assert (row["control_gaps"][0] > bound["outer_iteration_gap"]
            or row["control_gaps"][1] > bound["outer_rho_gap"])
