from repro_torch.data.synthetic import ClassificationData

__all__ = ["ClassificationData"]
