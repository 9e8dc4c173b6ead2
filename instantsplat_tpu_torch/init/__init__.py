from instantsplat_tpu_torch.init.aligner import GlobalAligner, PairPrediction  # noqa: F401
from instantsplat_tpu_torch.init.pairs import make_pair_indices  # noqa: F401
