from repro_torch.data.synthetic import LogConfig, SearchLog, generate_log
from repro_torch.data import features

__all__ = ["LogConfig", "SearchLog", "generate_log", "features"]
