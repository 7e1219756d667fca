"""Architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "build_model"]

_MODULES = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


def build_model(cfg: ArchConfig):
    """The reference's family dispatch: the encoder-decoder LM for the
    ``audio`` family, the decoder-only LM for every other (dense, moe,
    vlm, hybrid, ssm)."""
    if cfg.family == "audio":
        from repro_torch.models.encdec import build_encdec
        return build_encdec(cfg)
    from repro_torch.models.transformer import build_lm
    return build_lm(cfg)
