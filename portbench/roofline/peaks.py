"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bfloat16": 989e12,     # tensor cores, dense
             "float16": 989e12,
             "tf32": 495e12,
             "float32": 67e12}       # outside the tensor cores
BF16_OPS_PER_S = OPS_PER_S["bfloat16"]
