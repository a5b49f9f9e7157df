"""Calibrated cost-model subsystem (DESIGN.md §5; counterpart of
`repro.costmodel`, pure Python and numpy, exactly equal on the same
inputs).

Three layers:

  * `profiles` — loadable hardware characterization tables (sectioned CSV
    in the ESL-CGRA `characterization.py` shape, or TOML), schema-validated.
    The port ships one profile under `costmodel/profiles/`,
    `paper_fpga_45nm` (the budget scheduler's default, validated against
    the paper's headline ratios), beside the measured paper-scale trace;
    any other profile loads by path.
  * `model` — the analytical access/latency/energy accounting model
    (`HwParams`, `Account`, `account_stage`, `account_window`), driven by a
    loaded profile instead of baked-in literals.
  * `scheduler` — `BudgetScheduler`: spends an energy or latency budget
    across the windows of a batch, allocating adaptive iterations where
    the predicted variance gain per joule/millisecond is highest. It sets
    the iteration caps of `core.pipeline.estimate_batch_budgeted`, exposed
    as per-request QoS classes by `launch.serve`.
"""
from .model import (Account, HwParams, MemGroup, PassCost, account_stage,
                    account_window, load_profile, pass_cost, sort_cost)
from .profiles import (PROFILE_DIR, MissingSectionError, ProfileError,
                       UnknownKeyError, available_profiles, paper_trace,
                       read_profile_dict)
from .scheduler import Allocation, BudgetScheduler, StagePlan, WindowPlan

__all__ = [
    "Account", "Allocation", "BudgetScheduler", "HwParams", "MemGroup",
    "MissingSectionError", "PROFILE_DIR", "PassCost", "ProfileError",
    "StagePlan", "UnknownKeyError", "WindowPlan", "account_stage",
    "account_window", "available_profiles", "load_profile", "paper_trace",
    "pass_cost", "read_profile_dict", "sort_cost",
]
