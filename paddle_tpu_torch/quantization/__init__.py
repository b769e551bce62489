"""Weight-only int8 quantization of the decode params (PyTorch port of
``paddle_tpu/quantization/decode.py``)."""
from .decode import (decode_weight_bytes, dequantize_for_decode,
                     is_quantized_params, quantize_for_decode)

__all__ = ["quantize_for_decode", "dequantize_for_decode",
           "is_quantized_params", "decode_weight_bytes"]
