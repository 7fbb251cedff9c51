"""The port's hand-written training kernels and the functions over them
(counterpart: ``paddle_tpu/ops/pallas/``): flash attention K1-K3
(:mod:`.fa_kernel`, :mod:`.flash_attention`), multi-tensor AdamW K4
(:mod:`.adamw_kernel`) and the weight-only GEMM K7
(:mod:`.weight_only_kernel`, which replaces an XLA fusion, not a Pallas
kernel). Sources are under ``csrc/``; nothing is built at import."""
from . import adamw_kernel, fa_kernel, flash_attention, weight_only_kernel

KERNEL_LIBRARIES = (fa_kernel.KERNEL_LIBRARY, adamw_kernel.KERNEL_LIBRARY,
                    weight_only_kernel.KERNEL_LIBRARY)

__all__ = ["adamw_kernel", "fa_kernel", "flash_attention",
           "weight_only_kernel", "KERNEL_LIBRARIES"]
