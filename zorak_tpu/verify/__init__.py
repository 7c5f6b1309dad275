from .nulltest import (
    AUDIO_EPS, SCALAR_EPS, NullReport, apply_slider_state, compare_audio,
    compare_states, export_bundle, golden_render, null_test_plugin,
    make_initialized_shadow,
)
