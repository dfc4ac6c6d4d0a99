"""FedRank core: features, the ranking Q-net, pairwise losses, double-Q
learning, imitation-learning pretraining, the FedRank policy and the
paper's baselines."""
from repro_torch.core.baselines import (
    AFLPolicy,
    ExpertPolicy,
    FavorPolicy,
    FedMarlPolicy,
    OortPolicy,
    OortTelemetryPolicy,
    RandomPolicy,
    TiFLPolicy,
)
from repro_torch.core.fedrank import FedRankPolicy, make_fedrank_variant
from repro_torch.core.features import (
    FEATURE_DIM,
    STATE_DIM,
    FeatureSet,
    Paper6FeatureSet,
    TelemetryFeatureSet,
    available_feature_sets,
    featurize,
    get_feature_set,
    register_feature_set,
)
from repro_torch.core.imitation import (
    Demonstration,
    augment_demonstrations,
    collect_demonstrations,
    pretrain_qnet,
)
from repro_torch.core.qnet import apply_qnet, hard_update, init_qnet, soft_update
from repro_torch.core.ranking import (
    pairwise_bce,
    pairwise_bce_hard,
    pairwise_soft_targets,
    ranking_accuracy,
    topk_overlap,
)

__all__ = [
    "RandomPolicy", "AFLPolicy", "TiFLPolicy", "OortPolicy",
    "OortTelemetryPolicy", "FavorPolicy", "FedMarlPolicy", "ExpertPolicy",
    "FedRankPolicy", "make_fedrank_variant",
    "featurize", "STATE_DIM", "FEATURE_DIM",
    "FeatureSet", "Paper6FeatureSet", "TelemetryFeatureSet",
    "get_feature_set", "register_feature_set", "available_feature_sets",
    "init_qnet", "apply_qnet", "soft_update", "hard_update",
    "pairwise_bce", "pairwise_bce_hard", "pairwise_soft_targets",
    "ranking_accuracy", "topk_overlap",
    "Demonstration", "collect_demonstrations", "augment_demonstrations",
    "pretrain_qnet",
]
