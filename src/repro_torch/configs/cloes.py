"""The paper's own model: the production CLOES configuration.

Taobao deploys a 3-stage cascade (§4.2 "Taobao search system now applies
the CLOES of 3 stages") trained with the full L3 objective; the operational
targets are 130 ms latency, >= 200 results, < 70% cluster utilization
(§4.1), and the online hyper-parameters are beta=5 (normal days; 10 for
Singles' Day), delta=1, eps=0.05, purchase weight eps=10, price weight
mu=3 (the best-GMV row of Table 4).
"""

from repro_torch.core.cascade import CascadeConfig
from repro_torch.core.losses import LossConfig
from repro_torch.data import features as F

N_STAGES = 3

_masks = F.default_stage_masks(N_STAGES)

CASCADE = CascadeConfig(
    n_stages=N_STAGES,
    d_x=F.N_FEATURES,
    d_q=F.N_QUERY_BUCKETS,
    masks=_masks,
    stage_times=F.stage_costs(_masks),
)

# normal business days (§5.2)
LOSS = LossConfig(beta=5.0, delta=1.0, eps_latency=0.05,
                  eps_purchase=10.0, mu_price=3.0,
                  n_o=200.0, t_l=130.0)

# Singles' Day peak (§5.4: "finally we set beta as 10")
LOSS_PEAK = LossConfig(beta=10.0, delta=1.0, eps_latency=0.05,
                       eps_purchase=10.0, mu_price=3.0,
                       n_o=200.0, t_l=130.0)
