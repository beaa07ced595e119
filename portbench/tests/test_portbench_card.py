"""The benchmark on the card at small sizes: a traced run reads device time
from the profiler, and the reference agrees with the port's kernel path.
Run on a card with `python -m pytest portbench/tests -m cuda -q`."""

import os
import time

import pytest
import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from portbench import harness
from portbench.kinds import common, search

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"config": {"min_level": 2, "max_level": 6},
         "traffic": {"order": [0, 4, 7, 9], "check_trees": 4, "trace_requests": 2}}


@pytest.mark.cuda
def test_a_traced_run_reads_the_device(cuda):
    result = harness.run(ROOT, "poisson2d_511.search", 2 ** 31 + 11, 2.0, True,
                         time.monotonic(), device="cuda", overrides=SMALL)
    assert result["correct"], result["checks"]
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert 0.0 < device["busy_s"] <= device["window_s"]
    metrics = result["metrics"]
    assert 0.0 < metrics["rb_sweep_roofline.search"]["value"] <= 105.0
    assert 0.0 <= metrics["idle_share.search"]["value"] < 100.0
    assert len(result["breakdown"]["device_ops"]) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("index", [4, 7, 9])
def test_the_reference_matches_the_kernel_path(cuda, index):
    config = {"name": "poisson2d_511", "min_level": 2, "max_level": 6, "grammar_depth": 4,
              "maximum_local_system_size": 8, "iteration_limit": 500,
              "residual_target": 1e-12, "power_error_seed": 7}
    text = common.read_pool(os.path.join(common.HERE, "data", "poisson2d_511_trees.txt"))[index]
    problem = poisson_2d(2, 6, dtype=torch.float32)
    pset, _ = common.primitive_set(problem, config)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                      device=cuda)
    expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
    t, rho, it = generator.generate_and_evaluate(expr, evaluation_samples=1)
    reference = search.reference_fitness(text, config, cuda)
    rho_gap, iteration_gap = search.gaps({"t": t, "rho": rho, "it": it}, reference)
    assert rho_gap < 1e-4 and iteration_gap == 0.0, (reference, (t, rho, it))
