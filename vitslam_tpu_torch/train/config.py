"""The train keys of ``configs/train_featureAlignedVGGT_vkitti.yaml`` as a
dict, for callers that run with torch and numpy alone and parse no YAML
(``chip_smoke.py``, ``profile_slice.py``): freeze list, loss weights and
warmups, optimizer, GT alignment, chunk sampling and seed.
``tests/test_torch_train.py`` holds it equal to the file."""

VKITTI_TRAIN_CFG = {
    "exp_name": "train_featureAlignedVGGT_vkitti", "seed_value": 42, "accum_steps": 1,
    "num_overlap": [1, 5], "sample_mode": "chunk_overlap", "chunk_width": [3, 20],
    "gt_alignment_type": "scale_from_depths", "val_epoch_freq": 250, "max_steps": 70000,
    "shape_buckets": [[5, 1], [10, 2], [20, 5]],
    "loss": {
        "cameraPose": {"weight": 1.0, "warmup_percent": 0.02, "warmup_type": "linear",
                       "loss_type": "l1"},
        "cameraPoseRel": {"weight": 0.5, "warmup_start_percent": 0.02, "warmup_percent": 0.02,
                          "warmup_type": "linear", "loss_type": "l1"},
        "depth": {"weight": 0.1, "warmup_start_percent": 0.02, "warmup_percent": 0.02,
                  "warmup_type": "linear", "valid_range": 0.98},
        "perFrameReg": {"weight": 5.0, "warmup_start_percent": 0.01, "warmup_percent": 0.01,
                        "warmup_type": "linear"},
        "perChunkReg": {"weight": 5.0, "warmup_percent": 0.01, "warmup_type": "linear"},
    },
    "optim": {
        "frozen_module_names": ["*aggregator*", "*camera_head*", "*depth_head*"],
        "optimizer": {"weight_decay": 0.05},
        "gradient_clip": {"max_norm": 1.0},
        "options": {"lr": {"min_value": 1.0e-8, "max_value": 5.0e-5, "linear_steps": 0.05}},
    },
}
