"""Analytic model FLOPs of a train step, and the card's peak.

The port's own copy of ``transformer_train_flops``,
``encdec_train_flops``, ``vit_train_flops`` and ``image_train_flops`` from
``mpi_tensorflow_tpu/utils/flops.py`` (transformers: PaLM-appendix
accounting, 6 N flops per token for a matmul of N parameters with its
backward, 12 B S^2 E per layer for attention scores and values, the tied
decoder counted at the positions that reach the head; the MoE family
keeps the dense formula, each token routed through one expert of the
dense MLP's width; image models: the forward GFLOPs per image at the
input geometry, times 3 for forward and backward).  The peaks are the
H100 SXM's (NVIDIA data sheet, dense): 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in float32 outside them, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_TFLOPS = {"bf16": 989.0, "fp32": 67.0}
HBM_TBPS = 3.35

# forward GFLOPs per image (2 x MACs) at the bench's input geometry: the
# ResNets' published MACs (ResNet-50 4.09 GMAC at 224x224, ResNet-20 41
# MMAC at 32x32), the CNN's two convs and two fc layers at 28x28
_IMAGE_FWD_GFLOPS = {"resnet50": 8.2, "resnet20": 0.082,
                     "mnist_cnn": 0.024}


def transformer_train_flops(cfg, batch: int, seq_len: int,
                            head_positions: int | None = None) -> float:
    """Model flops for ONE forward+backward step of the transformer stack
    (``models/bert.py`` geometry).  ``head_positions``: tokens reaching
    the MLM head per sequence (default: ``ce_capacity`` under masked
    packing, S otherwise)."""
    E, L, M, V = cfg.hidden, cfg.layers, cfg.mlp, cfg.vocab_size
    B, S = batch, seq_len
    layer_mm = 4 * E * E + 2 * E * M        # QKV + out proj, MLP
    enc = 6 * B * S * L * layer_mm          # encoder matmuls, fwd+bwd
    attn = 12 * L * B * S * S * E           # scores + AV, fwd+bwd
    if head_positions is None:
        if getattr(cfg, "ce_positions", "all") == "masked":
            from mpi_tensorflow_torch.models.bert import ce_capacity

            head_positions = ce_capacity(cfg, S)
        else:
            head_positions = S
    P = B * head_positions
    head = 6 * P * (E * E + V * E)          # transform + tied decoder
    return float(enc + attn + head)


def encdec_train_flops(cfg, n_dec: int, batch: int, src_len: int,
                       tgt_len: int) -> float:
    """One forward+backward step of the encoder-decoder family: the
    encoder's accounting without a head, the decoder layers' matmuls
    (self-attention and MLP at T, the cross-attention's q and out at T,
    its k and v at S), causal self-attention (T^2) and cross-attention
    (T S) counted as full products, and the tied head at every target
    position."""
    E, M, V = cfg.hidden, cfg.mlp, cfg.vocab_size
    B, S, T = batch, src_len, tgt_len
    enc = transformer_train_flops(cfg, B, S, head_positions=0)
    dec_mm = 6 * n_dec * (B * T * (6 * E * E + 2 * E * M)
                          + B * S * 2 * E * E)
    attn = 12 * n_dec * B * E * (T * T + T * S)
    head = 6 * B * T * V * E
    return float(enc + dec_mm + attn + head)


def vit_train_flops(vcfg, batch: int) -> float:
    """One forward+backward step of the ViT family (``models/vit.py``):
    the encoder's accounting (``transformer_train_flops`` with no head)
    at N = patches + CLS tokens, plus the patch projection; the
    classification head is left out, as the reference leaves it."""
    from types import SimpleNamespace

    N = vcfg.num_patches + 1
    body = transformer_train_flops(
        SimpleNamespace(hidden=vcfg.hidden, layers=vcfg.layers,
                        mlp=vcfg.mlp, vocab_size=0),
        batch, N, head_positions=0)
    patch = 6 * batch * vcfg.num_patches \
        * (vcfg.patch ** 2 * vcfg.channels) * vcfg.hidden
    return float(body + patch)


def image_train_flops(model_name: str, batch: int,
                      cfg=None) -> float | None:
    """Model flops of one forward+backward step of an image family at
    ``batch`` images, or None for a model with no number recorded.  The
    ViT's count follows its configuration: ``vit_train_flops(cfg)``
    when ``cfg`` (a ``VitConfig``) is given."""
    if model_name == "vit" and cfg is not None:
        return vit_train_flops(cfg, batch)
    g = _IMAGE_FWD_GFLOPS.get(model_name)
    if g is None:
        return None
    return 3.0 * g * 1e9 * batch


def mfu(flops_per_step: float, step_seconds: float, precision: str) -> float:
    """Model-FLOP utilisation against the card's peak for ``precision``
    ("bf16" or "fp32")."""
    return flops_per_step / step_seconds / (PEAK_TFLOPS[precision] * 1e12)
