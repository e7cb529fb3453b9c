"""Pluggable power-policy subsystem (the scan engine's controllers); port
of `repro.core.policies`.

See `repro_torch.core.policies.base` for the contract.
"""
from repro_torch.core.policies.base import (BRANCH_TAG_SLOT, BRANCHES,
                                            POLICY_PARAM_DIM,
                                            POLICY_STATE_DIM, Branch,
                                            Policy, PolicyObs,
                                            as_branches, branch_extras,
                                            branch_init, branch_on_change,
                                            branch_step, branch_tag,
                                            pack_values, policy_init,
                                            policy_step, policy_values,
                                            register_branch, resolve_kinds,
                                            tag_branch)
from repro_torch.core.policies.dutycycle import DutyCyclePolicy
from repro_torch.core.policies.offline_rl import (N_ACTIONS, N_FEATURES,
                                                  OfflineRLPolicy,
                                                  build_dataset, features,
                                                  fit_offline_rl)
from repro_torch.core.policies.pi import PIPolicy

__all__ = [
    "BRANCHES", "Branch", "Policy", "PolicyObs", "POLICY_PARAM_DIM",
    "POLICY_STATE_DIM", "PIPolicy", "OfflineRLPolicy", "DutyCyclePolicy",
    "as_branches", "branch_extras", "branch_init", "branch_on_change",
    "branch_step",
    "build_dataset", "features", "fit_offline_rl", "pack_values",
    "policy_init", "policy_step", "policy_values", "register_branch",
    "resolve_kinds", "N_ACTIONS", "N_FEATURES", "BRANCH_TAG_SLOT",
    "branch_tag", "tag_branch",
]
