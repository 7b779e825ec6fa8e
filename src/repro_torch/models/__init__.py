"""The LLM model zoo of the port, every family (dense, moe, ssm, hybrid,
encdec): configurations and parameter templates (`base`), the layers
(`layers`) and the forward pass (`zoo`). The serving engine (`serving.engine`) runs prefill and decode on
them, on one card or over ranks (`parallel`: the "tp" layout); the neural
final stage of the cascade (`serving.cascade_server.NeuralScorer`) scores
items with them."""
