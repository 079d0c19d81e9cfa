"""Paper core, ported: long-tail early stopping for iterative clustering.

Pipeline (paper §4): sample → group → trace training groups to convergence →
fit h(r) regression → pick h* = f(r*) → early-stop production runs.
"""
from .rand_index import (rand_index, contingency_table,
                         rand_index_from_contingency,
                         rand_index_from_contingency_f32)
from .regression import (RegressionModel, FitMetrics, fit_family, select_model,
                         pool_traces, rh_from_objectives, FAMILIES)
from .earlystop import LongTailModel, fit_longtail, change_rate
from .longtail_train import (TrainingPlan, config_fingerprint, harvest_config,
                             harvest_traces, fit_for_config,
                             engine_trace_to_rh)
from .kmeans import (kmeans_step, kmeans_plus_plus_init, random_init,
                     assign_and_stats, update_centroids)
from .em_gmm import (GMMParams, em_step, init_from_kmeans, estep_stats,
                     log_prob, mstep)
from .engine import (ClusteringEngine, EngineConfig, EngineResult, Trace,
                     KMeansAlgorithm, EMAlgorithm, get_algorithm)
from .sampling import GroupedData, random_groups, kfold_split, make_grouped
from .cost_model import CostReport, report, EC2_ON_DEMAND_USD_PER_HOUR
from .convert import params_from_numpy, params_to_numpy
