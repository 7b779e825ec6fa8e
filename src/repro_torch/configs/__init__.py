"""Model configurations. The serving slice carries the paper's CLOES
cascade (`configs.cloes`); the LLM architecture zoo comes with the
neural final stage."""
