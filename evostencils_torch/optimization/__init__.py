from evostencils_torch.optimization.optimizer import Optimizer  # noqa: F401
