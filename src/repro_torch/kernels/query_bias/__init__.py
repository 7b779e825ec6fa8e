"""query_bias: the serving cascade's per-query stage biases zq = q @ w_q.T
+ b, summed in a fixed order per row (`kernel.py` wraps
`csrc/query_bias.cu`; `ref.py` is its plain PyTorch version). A port-only
kernel: the reference computes zq in XLA."""
