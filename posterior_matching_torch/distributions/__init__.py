from posterior_matching_torch.distributions._math import (
    fill_scale_tril,
    fill_triangular,
    kl_diag_tril,
    softplus_scale,
    tril_size,
)
from posterior_matching_torch.distributions.discrete import Bernoulli
from posterior_matching_torch.distributions.logistic import QuantizedLogisticMixture
from posterior_matching_torch.distributions.mixture import GMM1D
from posterior_matching_torch.distributions.normal import (
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    Noise,
    Normal,
    standard_normal,
)

__all__ = [
    "Bernoulli", "GMM1D", "MultivariateNormalDiag", "MultivariateNormalTriL", "Noise",
    "Normal", "QuantizedLogisticMixture", "fill_scale_tril", "fill_triangular",
    "kl_diag_tril", "softplus_scale", "standard_normal", "tril_size",
]
