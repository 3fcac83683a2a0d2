from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.data.synthetic import CharLMData, ClassificationData

__all__ = ["CharLMData", "ClassificationData", "TokenStream",
           "TokenStreamConfig"]
