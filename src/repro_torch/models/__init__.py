"""The LLM model zoo of the port, dense and moe families: configurations and
parameter templates (`base`), the layers (`layers`) and the forward pass
(`zoo`). The serving engine (`serving.engine`) runs prefill and decode on
them; the neural final stage of the cascade
(`serving.cascade_server.NeuralScorer`) scores items with them."""
