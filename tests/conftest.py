"""Test env: force CPU JAX with 8 virtual devices so sharding/multichip tests
run without TPU hardware (the standard JAX substitute for a fake cluster).

Some site plugins import jax before this conftest runs, so besides setting the
env vars we also reconfigure jax directly — that works as long as the backend
has not been initialised yet (first device call), which is the case at pytest
collection time.  x64 is enabled so float64 parity tests against scipy/numpy
oracles are meaningful; ops take their dtype from inputs, so float32 behaviour
is still exercised by passing float32 arrays.
"""

import os
import sys

# POLARDEPTH_TEST_TPU=1 opts the run into the real accelerator (for the
# TPU-gated Mosaic/Pallas numerics tests, which skip themselves on CPU);
# everything else keeps the virtual 8-device CPU mesh.
_USE_TPU = os.environ.get("POLARDEPTH_TEST_TPU") == "1"

if not _USE_TPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if not _USE_TPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
if not _USE_TPU:
    # x64 parity tests against float64 scipy/numpy oracles; TPU runs keep
    # the native f32 world (f64 is unsupported on the MXU).
    os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402  (import position is the point)

if not _USE_TPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the train-step graphs take minutes to
# compile on CPU; cached binaries make repeat test runs fast.
_CACHE = os.path.join(os.path.dirname(__file__), os.pardir, ".jax_cache")
jax.config.update("jax_compilation_cache_dir", os.path.abspath(_CACHE))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402

# Measured slow tier (VERDICT r3 #7 / r4 #5): every test whose *call* took
# >=10 s in the full-suite `--durations=0` run of 2026-08-20 (285 tests,
# 1:17:54 single-process on the 1-core CI host; log: pytest_durations).
# Keeping the ledger here rather than as per-file decorators lets us mark
# individual parametrizations (e.g. only the [cmd0] CLI smoke) and keeps the
# tier data-driven: re-measure, regenerate, done.  Entries are exact nodeids;
# a bare "file.py::name" entry also matches every parametrization of `name`.
_SLOW_MEASURED = {
    "test_apps_utils.py::test_cli_selfsup_smoke[extra0]",
    "test_apps_utils.py::test_cli_smoke[cmd0]",
    "test_apps_utils.py::test_cli_smoke[cmd1]",
    "test_attention.py::test_arch1pp_attention_network_forward",
    "test_bf16_parity.py::test_bf16_metric_delta_small",
    "test_cost_volume.py::test_bf16_volume_close_to_f32",
    "test_cost_volume.py::test_bin_chunking_is_exact",
    "test_cost_volume.py::test_cost_volume_encoder_forward_shapes",
    "test_cost_volume.py::test_packed_gather_matches_four_gather_grid_sample",
    "test_cost_volume.py::test_zero_pose_frame_is_ignored",
    "test_dpt.py::test_dpt_gradients_flow",
    "test_dpt.py::test_dpt_hybrid_forward",
    "test_dpt.py::test_dpt_train_step",
    "test_dpt.py::test_dpt_vitb16_forward",
    "test_dpt_transforms.py::test_depth_model_unchanged_param_names",
    "test_dpt_transforms.py::test_segmentation_model_forward_and_bn",
    "test_dpt_weights.py::test_hybrid_graft_roundtrip",
    "test_dpt_weights.py::test_resnetv2_trunk_shapes",
    "test_eval_protocol.py::"
    "test_post_process_composes_plain_and_mirrored_branch",
    "test_export.py::test_export_dpt_graph",
    "test_export.py::test_export_rgb_only_graph",
    "test_export.py::test_export_roundtrip_symbolic_batch",
    "test_flags.py::test_12channel_mode_end_to_end",
    "test_flags.py::test_avg_reprojection_changes_loss",
    "test_flags.py::test_log_frequency_periodic_callback",
    "test_flags.py::test_num_matching_frames_changes_student_graph",
    "test_flags.py::test_selfsup_native_resolution_batch",
    "test_flags.py::test_v1_multiscale_changes_loss",
    "test_fused_encoders.py::test_network_forward_fused",
    "test_fused_encoders.py::test_teacher_paths_carry_fused_encoders",
    "test_fused_encoders.py::"
    "test_network_fused_matches_separate_with_converted_params",
    "test_kitti_flow.py::test_kitti_train_step_runs",
    "test_models.py::test_polardepthnet_end_to_end[True-True]",
    "test_packed_losses.py::test_packed_grads_match",
    "test_packed_losses.py::test_selfsup_losses_packed_parity[False-False]",
    "test_packed_losses.py::test_supervised_packed_grads_match",
    "test_pallas_preprocess.py::test_kernel_matches_exact_path_interpret",
    "test_parallel.py::test_spatial_partition_eval_matches",
    "test_parallel.py::test_spatial_partition_matches_single_device",
    "test_parallel.py::test_tp_step_matches_single_device",
    "test_parallel.py::test_tri_tp_spec_rules",
    "test_parallel.py::test_tri_tp_step_matches_single_device",
    "test_phase_decoder.py::test_decoder_phase_packed_exact_f64[zero]",
    "test_phase_decoder.py::test_decoder_phase_packed_f32_tol",
    "test_phase_decoder.py::test_decoder_phase_packed_grad_parity",
    "test_phase_decoder.py::test_phase_ops_exact_f64[zero]",
    "test_pretrained_loading.py::test_trainer_consumes_weights_init",
    "test_resnext.py::test_midasnet_resnext_forward_and_graft",
    "test_round3_wiring.py::test_supervised_train_step_honors_random_flip",
    "test_selfsup.py::test_selfsup_res_pose_step",
    "test_selfsup.py::test_selfsup_train_step_runs_and_improves[False]",
    "test_selfsup.py::test_selfsup_train_step_runs_and_improves[True]",
    "test_student.py::test_student_data_parallel_8_devices_matches_single",
    "test_student.py::test_student_train_step_runs",
    "test_train.py::test_checkpoint_roundtrip",
    "test_train.py::test_data_parallel_8_devices_matches_single_device",
    "test_train.py::test_fit_kill_resume_identical_batch_sequence",
    "test_train.py::test_multi_eval_equals_sequential_eval",
    "test_train.py::test_multi_step_scan_matches_sequential",
    "test_train.py::test_overfit_single_batch_loss_decreases",
    "test_train.py::test_rgb_only_config_trains",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: expensive end-to-end/convergence test, skipped by default; "
        "run with --runslow or POLARDEPTH_SLOW_TESTS=1 (VERDICT r3 #7)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips itself where there is none")


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow")


def _measured_slow(item):
    nodeid = item.nodeid.rsplit("/", 1)[-1]  # strip the tests/ dir prefix
    if nodeid in _SLOW_MEASURED:
        return True
    base = nodeid.split("[", 1)[0]
    return base in _SLOW_MEASURED


def pytest_collection_modifyitems(config, items):
    for item in items:
        if _measured_slow(item):
            item.add_marker(pytest.mark.slow)
    if config.getoption("--runslow") or \
            os.environ.get("POLARDEPTH_SLOW_TESTS") == "1":
        return
    skip = pytest.mark.skip(
        reason="slow tier (use --runslow / POLARDEPTH_SLOW_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
