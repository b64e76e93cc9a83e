"""Utils tests: config round-trip, throughput meter, BMP synth/parse."""

import numpy as np
import pytest

from gr_ldpc_ece535a_tpu.utils import (
    ChannelConfig,
    ReceiverConfig,
    SimConfig,
    ThroughputMeter,
    Timer,
    make_bmp,
    parse_bmp_header,
)


def test_receiver_config_defaults_match_reference():
    cfg = ReceiverConfig()
    assert (cfg.method, cfg.iterations, cfg.max_errors) == (0, 5, 10)
    blk = cfg.make_block()
    assert blk.iterations == 5
    assert blk.threshold == 32 // 8  # M/8 derived
    assert blk.max_errors == 10


def test_config_yaml_roundtrip(tmp_path):
    cfg = ReceiverConfig(method=1, iterations=20, verbose=False)
    p = tmp_path / "rx.yaml"
    cfg.to_yaml(p)
    assert ReceiverConfig.from_yaml(p) == cfg
    with pytest.raises(ValueError, match="unknown keys"):
        ReceiverConfig.from_dict({"bogus": 1})


def test_channel_config_selects_block():
    from gr_ldpc_ece535a_tpu.blocks import AwgnBlock, ChannelModelBlock
    assert isinstance(ChannelConfig(ebn0_db=5.0).make_block(), AwgnBlock)
    assert isinstance(ChannelConfig(noise_voltage=0.1).make_block(),
                      ChannelModelBlock)


def test_sim_config_runs():
    res = SimConfig(code="sim_8_16", start_db=0.0, stop_db=4.0, step_db=4.0,
                    frames_per_point=80, iterations=2,
                    methods=("hard",)).run()
    assert res.ber["hard"].shape == (2,)


def test_throughput_meter_and_timer():
    m = ThroughputMeter("bits")
    with m.step(1000):
        pass
    m.add(500, 0.5)
    assert m.steps == 2
    assert m.rate == pytest.approx(1500 / m.seconds)
    with Timer() as t:
        pass
    assert t.elapsed >= 0


def test_make_bmp_parses_and_reassembles(tmp_path):
    img = make_bmp(np.arange(5 * 3 * 3, dtype=np.uint8).reshape(5, 3, 3))
    hdr = parse_bmp_header(img)
    assert hdr is not None
    assert hdr["file_size"] == len(img)
    assert hdr["dib_size"] == 40
    assert parse_bmp_header(b"nope" * 8) is None
    # the image sink must accept a synthesized BMP
    from gr_ldpc_ece535a_tpu.blocks import FlowGraph, ImageSink, VectorSource
    out = tmp_path / "r.bmp"
    fg = FlowGraph()
    fg.connect(VectorSource(np.frombuffer(img + b"\x00" * 20, np.uint8)),
               ImageSink(out_path=str(out), verbose=False))
    fg.run()
    assert out.read_bytes() == img


def test_enable_persistent_compile_cache(monkeypatch):
    """Respects JAX_COMPILATION_CACHE_DIR; otherwise registers the fixed
    <checkout>/.jax_cache directory."""
    from pathlib import Path

    from gr_ldpc_ece535a_tpu.utils import enable_persistent_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/already/set")
    assert enable_persistent_compile_cache() == "/already/set"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    import jax

    want = Path(__file__).resolve().parents[1] / ".jax_cache"
    prev = jax.config.jax_compilation_cache_dir
    try:
        got = enable_persistent_compile_cache()
        assert got == str(want) and want.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
