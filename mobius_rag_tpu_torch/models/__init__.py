from mobius_rag_tpu_torch.models.encoder import (EncoderConfig, EncoderModel,  # noqa: F401
                                                 init_params)
from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer  # noqa: F401
