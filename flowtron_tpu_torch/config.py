"""Config system: JSON file + dotted-path CLI overrides.

The public config API matches the reference exactly (it is part of the CLI
contract, reference:train.py:39-57 and reference:config.json:1-67): a JSON
file with ``train_config`` / ``data_config`` / ``dist_config`` /
``model_config`` sections, and ``-p a.b.c=value`` overrides whose values are
parsed with ``ast.literal_eval`` when possible.
"""

import ast
import copy
import json

DEFAULT_CONFIG = {
    "train_config": {
        "output_directory": "outdir",
        "epochs": 10000000,
        "optim_algo": "RAdam",
        "learning_rate": 1e-3,
        "weight_decay": 1e-6,
        "grad_clip_val": 1,
        "sigma": 1.0,
        "iters_per_checkpoint": 1000,
        "batch_size": 6,
        "seed": 1234,
        "checkpoint_path": "",
        "ignore_layers": [],
        "finetune_layers": [],
        "include_layers": ["speaker", "encoder", "embedding"],
        "warmstart_checkpoint_path": "",
        "with_tensorboard": True,
        "fp16_run": True,  # on TPU this selects the bfloat16 compute policy
        "gate_loss": True,
        "use_ctc_loss": True,
        "ctc_loss_weight": 0.01,
        "blank_logprob": -8,
        "ctc_loss_start_iter": 10000,
        # attention-prior anneal: linearly ramp the beta-binomial prior's
        # log-term strength 1 -> 0 between start_iter and end_iter, so the
        # model must internalize the alignment the scaffold was carrying.
        # end_iter=0 disables (constant full prior, reference behavior).
        "prior_anneal_start_iter": 0,
        "prior_anneal_end_iter": 0,
        # >0: decode N free-running syntheses back to characters every
        # validation and log validation/tone_cer_mel (coded-tone corpora
        # only — see data/tone_cer.py)
        "tone_cer_validation_texts": 0,
        "profile_dir": "",
        # directory-based per-shard checkpoint format (sharded_ckpt.py)
        # instead of the single-file pickle
        "sharded_checkpoints": False,
        # "" = pickle (or sharded when sharded_checkpoints is set);
        # explicit "pickle" | "sharded" | "orbax" overrides
        "checkpoint_format": "",
        # scan-level rematerialization: 3x lower peak memory, enables
        # batch_size >= 32 at flagship dims (see ROADMAP measurements)
        "remat": False,
    },
    "data_config": {
        "training_files": "filelists/train.txt",
        "validation_files": "filelists/val.txt",
        "text_cleaners": ["flowtron_cleaners"],
        "p_arpabet": 0.5,
        "cmudict_path": "data/cmudict_dictionary",
        "heteronyms_path": "",
        "sampling_rate": 22050,
        "filter_length": 1024,
        "hop_length": 256,
        "win_length": 1024,
        "mel_fmin": 0.0,
        "mel_fmax": 8000.0,
        "max_wav_value": 32768.0,
        "use_attn_prior": True,
        "attn_prior_threshold": 0.0,
        "prior_cache_path": "",
        "betab_scaling_factor": 1.0,
        "keep_ambiguous": False,
        "mel_cache_path": "",
        "use_native": False,
        # grain-backed loader (multi-host input sharding); filtered out
        # of Data.__init__ by data_kwargs' _NON_DATA_KEYS
        "use_grain": False,
        "grain_workers": 0,
    },
    "dist_config": {
        # TPU-native: data-parallel mesh axes instead of NCCL rendezvous.
        "mesh_shape": [-1],          # -1 = all available devices on 'data'
        "mesh_axis_names": ["data"],
        # multi-process (multi-host) init: multiprocess=True auto-detects
        # (TPU pods); an explicit coordinator_address + num_processes +
        # process_id overrides (parallel/mesh.py)
        "multiprocess": False,
        "coordinator_address": "",
        "num_processes": None,
        "process_id": None,
        # per-axis process counts for multi-slice DCN hybrid meshes
        "dcn_mesh_shape": None,
    },
    "model_config": {
        "n_speakers": 1,
        "n_speaker_dim": 128,
        "n_text": 185,
        "n_text_dim": 512,
        "n_flows": 2,
        "n_mel_channels": 80,
        "n_attn_channels": 640,
        "n_hidden": 1024,
        "n_lstm_layers": 2,
        "mel_encoder_n_hidden": 512,
        "n_components": 0,
        "mean_scale": 0.0,
        "fixed_gaussian": True,
        "dummy_speaker_embedding": False,
        "use_gate_layer": True,
        "use_cumm_attention": False,
    },
}


def update_params(config, params):
    """Apply ``a.b.c=value`` override strings to a nested config dict.

    Matches reference semantics: values are literal_eval'd when possible,
    unknown keys are reported but not added.
    """
    for param in params:
        k, v = param.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass

        k_split = k.split(".")
        if len(k_split) > 1:
            parent_k = k_split[0]
            cur_param = [".".join(k_split[1:]) + "=" + str(v)]
            update_params(config[parent_k], cur_param)
        elif k in config:
            config[k] = v
        else:
            print("{}, {} params not updated".format(k, v))


def load_config(path=None, overrides=()):
    """Load a config JSON (defaults filled in) and apply overrides. A
    top-level entry that is not a section (configs/config_multislice.json's
    ``_comment`` list) is kept as it is; the JAX package's copy raises on
    it."""
    config = copy.deepcopy(DEFAULT_CONFIG)
    if path is not None:
        with open(path) as f:
            user = json.load(f)
        for section, values in user.items():
            if isinstance(values, dict):
                config.setdefault(section, {}).update(values)
            else:
                config[section] = values
    if overrides:
        update_params(config, list(overrides))
    return config
