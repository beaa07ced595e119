from evostencils_torch.models.lfa import ConvergenceEvaluator  # noqa: F401
from evostencils_torch.models.roofline import PerformanceEvaluator  # noqa: F401
