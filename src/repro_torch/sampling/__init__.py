from repro_torch.sampling.adaptive import AdaptiveDistribution, pattern_losses_from_batch
from repro_torch.sampling.online import OnlineSampler, SampledQuery

__all__ = ["OnlineSampler", "SampledQuery", "AdaptiveDistribution",
           "pattern_losses_from_batch"]
