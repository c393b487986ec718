from .bert import BertConfig, BertEncoder, BertForMaskedLM, BertForSequenceClassification, mlm_loss
from .clip import CLIP, CLIPConfig, CLIPTextConfig, clip_loss
from .encoder import EncoderConfig, TransformerEncoder, encoder_partition_rules
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from .transformer import DecoderLM, TransformerConfig, load_flax_params, lm_loss, to_flax_params
from .vit import ViT, ViT_B16, ViT_L16, ViT_S16, ViTConfig

__all__ = ["BertConfig", "BertEncoder", "BertForMaskedLM", "BertForSequenceClassification", "CLIP", "CLIPConfig",
           "CLIPTextConfig", "DecoderLM", "EncoderConfig", "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "TransformerConfig", "TransformerEncoder", "ViT", "ViTConfig", "ViT_B16", "ViT_L16", "ViT_S16",
           "clip_loss", "encoder_partition_rules", "load_flax_params", "lm_loss", "mlm_loss", "to_flax_params"]
