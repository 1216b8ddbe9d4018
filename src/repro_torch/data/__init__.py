from repro_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
