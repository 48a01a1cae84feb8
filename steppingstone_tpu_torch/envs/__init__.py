from steppingstone_tpu_torch.envs.registry import ENV_IDS, make_env
