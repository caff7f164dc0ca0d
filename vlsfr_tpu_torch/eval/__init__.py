from vlsfr_tpu_torch.eval.extract import Embedder
from vlsfr_tpu_torch.eval.verification import (
    cosine_scores,
    identification_topk,
    kfold_verification_accuracy,
    make_verification_pairs,
    tar_at_far,
)
