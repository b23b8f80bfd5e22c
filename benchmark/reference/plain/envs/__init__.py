from .humanoid import (EnvParams, EnvState, StepOut, ExpertBatch,  # noqa: F401
                       BodyTables, make_body_tables, get_obs, get_body_quat,
                       get_ee_pos, reset, draw_reset, reset_from, step,
                       finish_step, apply_action, observe, select_state,
                       REWARD_FUNCS)
from .expert import (gen_expert_features, stack_experts,  # noqa: F401
                     synthetic_experts, zero_hands)
