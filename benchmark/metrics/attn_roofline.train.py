"""attn_roofline.train: the self- (L x L) and cross-attention (L x Lm)
forward and backward's bound (operations or bytes from the step's shapes,
benchmark/flops.py) over the device time of the kernels named attn_* in
the profiled steps (%)."""

from benchmark.readers import attention_roofline


def read(r):
    return attention_roofline(r, train=True)
