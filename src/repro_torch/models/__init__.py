"""Model zoo: the reference's language models (``configs.ARCH_IDS``), from blocks written in plain PyTorch.
Parameter-bearing contractions route through the relational engine
(``repro_torch.relational``): ``rel_linear`` for every projection and
``rel_embed`` for the token embedding."""

from .model import Model, build_model  # noqa: F401
