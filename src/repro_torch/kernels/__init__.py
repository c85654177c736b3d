"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and with a launch counter (``<wrapper>.launches``).

The submodules keep their names here (``kernels.flash_attention`` is the
module, not its function of the same name), and ``KERNELS`` names every
kernel wrapper by the name its counter is reported under.
"""

from typing import Dict

from repro_torch.kernels import banked_gather as _bg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quanta_apply as _qa
from repro_torch.kernels import quanta_linear as _ql
from repro_torch.kernels import quantized_matmul as _qm

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

KERNELS = {
    "quanta_apply": _qa.quanta_apply,
    "quanta_linear": _ql.quanta_linear,
    "flash_attention": _fa.flash_attention,
    "flash_decode_attention": _fa.flash_decode_attention,
    "paged_flash_decode_attention": _fa.paged_flash_decode_attention,
    "paged_flash_decode_attention_quant":
        _fa.paged_flash_decode_attention_quant,
    "quantized_matmul": _qm.quantized_matmul,
    "banked_lora_linear": _bg.banked_lora_linear,
    "banked_lora_delta": _bg.banked_lora_delta,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
