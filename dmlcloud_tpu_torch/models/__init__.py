from .transformer import DecoderLM, TransformerConfig, load_flax_params, lm_loss, to_flax_params

__all__ = ["DecoderLM", "TransformerConfig", "load_flax_params", "lm_loss", "to_flax_params"]
