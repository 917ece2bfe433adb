"""attn_roofline.sample: the decoder self-attention's bound (operations or
bytes from the request's shapes, benchmark/flops.py) over the device time
of the kernels named attn_* in one profiled request (%)."""

from benchmark.readers import attention_roofline


def read(r):
    return attention_roofline(r, train=False)
