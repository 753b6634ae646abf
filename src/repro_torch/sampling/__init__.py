from repro_torch.sampling.online import OnlineSampler, SampledQuery

__all__ = ["OnlineSampler", "SampledQuery"]
