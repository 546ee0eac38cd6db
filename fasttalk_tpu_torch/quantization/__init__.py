"""Int4 group-wise weight quantization tier (WEIGHT_QUANT=int4).

Counterpart of ``fasttalk_tpu/quantization/``: group-wise symmetric 4-bit
weights with nibble-packed storage (int4.py), the activation-aware AWQ
scale search run offline (awq.py, ``python -m fasttalk_tpu_torch
quantize``), and the serving path in ops/quant.py and ops/cuda_int4.py
(the hand-written ``int4_matmul`` kernel) that unpacks the bytes inside the
decode matmul.
"""

from fasttalk_tpu_torch.quantization.int4 import (GROUP_DEFAULT, INT4_LEAVES,
                                                  dequantize_int4,
                                                  group_size_of, is_int4,
                                                  pack_int4, quantize_group,
                                                  quantize_math_group,
                                                  quantize_params_int4,
                                                  quantizing_put_int4,
                                                  unpack_int4, validate_group)

__all__ = [
    "GROUP_DEFAULT", "INT4_LEAVES", "dequantize_int4", "group_size_of",
    "is_int4", "pack_int4", "quantize_group", "quantize_math_group",
    "quantize_params_int4", "quantizing_put_int4", "unpack_int4",
    "validate_group",
]
