"""The README's first entry points on the port: `quickstart` (the Table-3
trade-off in a minute), `train_ranker` (a smoke-sized neural final stage
trained on the cascade's survivor-scoring task) and `cascade_serving`
(a trained cascade behind the streaming session, with a neural final
stage). Run each as ``python -m repro_torch.examples.<name>``; each runs
on the CUDA card unless given ``--device cpu``."""
