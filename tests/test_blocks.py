"""Streaming block layer: loopback flowgraphs, sync state machine, image sink.

These are the analog of the reference's QA flowgraph tests
(python/qa_ldpc_encoder_bc.py / qa_ldpc_decoder_cb.py) — vector_source ->
block -> vector_sink around the block under test — plus sync-acquisition
cases the reference only exercised manually over the RF examples.
"""

import io

import numpy as np
import pytest

from gr_ldpc_ece535a_tpu.blocks import (
    AwgnBlock,
    DumpSink,
    FileSource,
    FlowGraph,
    ImageSink,
    LdpcDecoderBlock,
    LdpcEncoderBlock,
    NullSink,
    RandomSource,
    VectorSink,
    VectorSource,
)
from gr_ldpc_ece535a_tpu.codes import get_code


def _run_chain(*blocks):
    fg = FlowGraph()
    fg.connect(*blocks)
    fg.run()


def test_encoder_block_golden_structure():
    """8 input bytes -> 2 frames of 64 BPSK symbols; parity satisfies H."""
    code = get_code("block_32_64")
    data = np.arange(8, dtype=np.uint8)
    src = VectorSource(data)
    enc = LdpcEncoderBlock()
    snk = VectorSink(np.complex64)
    _run_chain(src, enc, snk)
    sym = snk.data()
    assert sym.shape == (128,)
    assert set(np.unique(sym.real)) == {-1.0, 1.0}
    assert np.allclose(sym.imag, 0)
    u = (sym.real.reshape(2, 64) > 0).astype(np.int64)
    assert not ((code.H.astype(np.int64) @ u.T) % 2).any()
    # data half must round-trip the input bytes (MSB-first)
    bits = u[:, code.M:].astype(np.uint8)
    assert bytes(np.packbits(bits)) == bytes(data)


@pytest.mark.parametrize("method", [0, 1])
def test_loopback_clean(method):
    msg = bytes(range(32, 96)) * 4
    src = VectorSource(np.frombuffer(msg, np.uint8))
    enc = LdpcEncoderBlock()
    dec = LdpcDecoderBlock(method=method, verbose=False)
    snk = VectorSink(np.uint8)
    _run_chain(src, enc, dec, snk)
    assert bytes(snk.data()) == msg


def test_loopback_noisy_sumproduct():
    msg = (b"The quick brown fox jumps over the lazy dog. " * 12)[:512]
    src = VectorSource(np.frombuffer(msg, np.uint8))
    enc = LdpcEncoderBlock()
    chan = AwgnBlock(ebn0_db=6.0, seed=3)
    dec = LdpcDecoderBlock(method=1, verbose=False)
    snk = VectorSink(np.uint8)
    _run_chain(src, enc, chan, dec, snk)
    out = bytes(snk.data())
    assert out == msg


def test_sync_acquires_after_symbol_offset():
    """Leading garbage symbols force the symbol-slip search to find the frame
    boundary (the reference slides one symbol at a time; here it's batched)."""
    msg = b"0123456789ABCDEF" * 8
    src = VectorSource(np.frombuffer(msg, np.uint8))
    enc = LdpcEncoderBlock()
    sym = VectorSink(np.complex64)
    _run_chain(src, enc, sym)
    stream = sym.data()
    offset_stream = np.concatenate(
        [np.asarray([0.3 - 0.1j] * 17, np.complex64), stream])
    # error_threshold=0 (strict syndrome) makes the lock deterministic; the
    # reference's lenient M/8=4 threshold can false-lock on misaligned
    # windows (the decoder pushes any input toward a codeword), which is
    # faithful behavior but not a stable test fixture.
    dec = LdpcDecoderBlock(method=0, error_threshold=0, verbose=False)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(offset_stream, np.complex64), dec, snk)
    out = bytes(snk.data())
    # sync must lock at the true boundary and recover the full message
    assert msg == out
    assert dec.state == 1  # IN_SYNC


def test_sync_phase_inverted_stream():
    """A 180-degree-rotated stream (Costas ambiguity) must lock via the
    IN_SYNC_INVERTED path and still recover the data."""
    msg = b"invertme" * 32
    src = VectorSource(np.frombuffer(msg, np.uint8))
    enc = LdpcEncoderBlock()
    sym = VectorSink(np.complex64)
    _run_chain(src, enc, sym)
    dec = LdpcDecoderBlock(method=0, verbose=False)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(-sym.data(), np.complex64), dec, snk)
    assert bytes(snk.data()) == msg
    assert dec.state == 2  # IN_SYNC_INVERTED


def test_sync_fall_out_on_garbage():
    """>10 consecutive bad frames while in sync must drop the lock."""
    msg = b"lockme!!" * 16
    src = VectorSource(np.frombuffer(msg, np.uint8))
    enc = LdpcEncoderBlock()
    sym = VectorSink(np.complex64)
    _run_chain(src, enc, sym)
    # Hard +-10 random symbols never decode near a codeword in 5 iterations
    # (low-amplitude noise would: the decoder pushes weak LLRs toward some
    # codeword and the lenient M/8 threshold re-locks — faithful reference
    # behavior, but the wrong fixture for testing fall-out).
    rng = np.random.default_rng(100)
    garbage = (np.sign(rng.standard_normal(64 * 16)) * 10).astype(np.complex64)
    stream = np.concatenate([sym.data(), garbage])
    dec = LdpcDecoderBlock(method=0, verbose=False)
    snk = VectorSink(np.uint8)
    _run_chain(VectorSource(stream, np.complex64), dec, snk)
    out = bytes(snk.data())
    assert out.startswith(msg)
    assert dec.state == 0  # OUT_OF_SYNC again at stream end


def test_dump_sink_prints_ascii():
    buf = io.StringIO()
    src = VectorSource(np.frombuffer(b"hello", np.uint8))
    _run_chain(src, DumpSink(stream=buf))
    assert buf.getvalue() == "hello"


def _tiny_bmp(payload: bytes = b"\x00" * 16) -> bytes:
    """A minimal valid-enough BMP: 14-byte file header + 40-byte DIB + data."""
    size = 14 + 40 + len(payload)
    hdr = b"BM" + size.to_bytes(4, "little") + b"\x00\x00\x00\x00" + (54).to_bytes(4, "little")
    dib = (40).to_bytes(4, "little") + b"\x00" * 36
    return hdr + dib + payload


def test_image_sink_reassembles_stream(tmp_path):
    img1 = _tiny_bmp(b"\x11" * 32)
    img2 = _tiny_bmp(b"\x22" * 8)
    stream = b"\xaa\xbb" + img1 + b"junk" + img2 + b"\x00" * 20
    out = tmp_path / "result.bmp"
    sink = ImageSink(out_path=str(out), every_image=True, verbose=False)
    src = VectorSource(np.frombuffer(stream, np.uint8), chunk=7)  # tiny chunks
    _run_chain(src, sink)
    assert sink.images_written == 2
    assert (tmp_path / "result_1.bmp").read_bytes() == img1
    assert (tmp_path / "result_2.bmp").read_bytes() == img2


def test_image_sink_handles_chunk_boundary_headers(tmp_path):
    """Headers split across work() chunks must still be found (improvement
    over the reference, which drops headers within 18 bytes of a boundary)."""
    img = _tiny_bmp(b"\x33" * 5)
    stream = b"x" * 3 + img
    sink = ImageSink(out_path=str(tmp_path / "r.bmp"), verbose=False)
    src = VectorSource(np.frombuffer(stream, np.uint8), chunk=4)
    _run_chain(src, sink)
    assert sink.images_written == 1
    assert (tmp_path / "r.bmp").read_bytes() == img


def test_full_image_loopback_over_channel(tmp_path):
    """example6.grc equivalent: BMP -> encode -> AWGN -> decode -> image sink."""
    img = _tiny_bmp(bytes(range(256)) * 2)
    pad = (-len(img)) % 4
    stream = img + b"\x00" * pad
    out = tmp_path / "result.bmp"
    fg = FlowGraph()
    src = VectorSource(np.frombuffer(stream * 2, np.uint8))
    enc = LdpcEncoderBlock()
    chan = AwgnBlock(ebn0_db=7.0, seed=1)
    dec = LdpcDecoderBlock(method=1, verbose=False)
    sink = ImageSink(out_path=str(out), verbose=False)
    fg.connect(src, enc, chan, dec, sink)
    fg.run()
    assert sink.images_written >= 1
    assert out.read_bytes() == img


def test_random_source_and_null_sink():
    src = RandomSource(32, 127, total=1000, seed=1)
    snk = NullSink()
    _run_chain(src, snk)
    assert snk.count == 1000


def test_image_sink_native_and_python_agree(tmp_path):
    """Both ImageSink scan paths (native C++ scanner vs pure Python) must
    produce identical files for the same chunked stream."""
    from gr_ldpc_ece535a_tpu import runtime
    img1 = _tiny_bmp(b"\x55" * 40)
    img2 = _tiny_bmp(b"\x66" * 12)
    stream = b"xy" + img1 + b"z" + img2 + b"\x00" * 25
    outs = {}
    for label, use_native in (("py", False), ("nat", None)):
        if use_native is None and not runtime.native_available():
            pytest.skip("no native runtime")
        out = tmp_path / f"{label}.bmp"
        sink = ImageSink(out_path=str(out), every_image=True, verbose=False,
                         use_native=use_native)
        src = VectorSource(np.frombuffer(stream, np.uint8), chunk=9)
        _run_chain(src, sink)
        outs[label] = (sink.images_written,
                       (tmp_path / f"{label}_1.bmp").read_bytes(),
                       (tmp_path / f"{label}_2.bmp").read_bytes())
    assert outs["py"] == outs["nat"]
    assert outs["py"][1] == img1 and outs["py"][2] == img2


def test_encoder_block_buckets_batch_shapes():
    """Varying stream chunk sizes must reuse a handful of jit programs
    (power-of-two buckets), not compile one per chunk length."""
    from gr_ldpc_ece535a_tpu.blocks import LdpcEncoderBlock

    blk = LdpcEncoderBlock()
    rng = np.random.default_rng(0)
    out_lens = []
    for n_bytes in (4, 12, 20, 36, 68, 100, 260, 516):
        _, out = blk.work(rng.integers(0, 256, n_bytes, dtype=np.uint8))
        out_lens.append(len(out))
    assert out_lens == [64 * n for n in (1, 3, 5, 9, 17, 25, 65, 129)]
    # 8 distinct chunk sizes -> at most 5 bucket shapes (16/32/64/128 pads
    # cover 1..129 frames at powers of two >= 16)
    assert blk._enc._cache_size() <= 5


def test_flowgraph_edge_backpressure_bounds_memory(monkeypatch):
    """A 10^7-item source ahead of a rate-limited consumer must hold
    bounded buffer, not the whole stream: the scheduler skips producers
    whose downstream edge is full (GR's circular-buffer backpressure,
    SURVEY.md L0 / round-3 VERDICT item 7)."""
    from gr_ldpc_ece535a_tpu.blocks import base as base_mod
    from gr_ldpc_ece535a_tpu.blocks import NullSink, Throttle, VectorSource

    cap, chunk = 1 << 16, 65536
    peak = {"size": 0}
    orig_push = base_mod._Edge.push

    def spy(self, data):
        orig_push(self, data)
        peak["size"] = max(peak["size"], self.size)

    monkeypatch.setattr(base_mod._Edge, "push", spy)
    total = 10**7
    src = VectorSource(np.arange(256, dtype=np.uint8), repeat=True,
                       max_items=total, chunk=chunk)
    thr = Throttle(rate=2e8)          # finishes in ~50 ms wall minimum
    sink = NullSink()
    fg = base_mod.FlowGraph(edge_capacity=cap)
    fg.connect(src, thr, sink)
    fg.run()
    assert sink.count == total
    # soft bound: capacity + one producer batch of overshoot
    assert peak["size"] <= cap + chunk, peak


def test_flowgraph_stall_guard_raises_on_undersized_capacity():
    """edge_capacity smaller than a consumer's minimum work unit must
    raise a clear error instead of spinning forever (the backpressure
    skip would otherwise livelock the demand loop)."""
    from gr_ldpc_ece535a_tpu.blocks import NullSink, VectorSource
    from gr_ldpc_ece535a_tpu.blocks.base import Block, FlowGraph

    class Needs100(Block):
        in_dtype = out_dtype = np.uint8
        name = "needs100"

        def work(self, data):
            if len(data) < 100:
                return 0, None
            return 100, data[:100]

    src = VectorSource(np.zeros(64, np.uint8), repeat=True,
                       max_items=10000, chunk=16)
    fg = FlowGraph(edge_capacity=32)          # < the 100-item work unit
    fg._stall_limit = 50                      # keep the test fast
    fg.connect(src, Needs100(), NullSink())
    with pytest.raises(RuntimeError, match="stalled"):
        fg.run()


def test_image_sink_display_cmd_side_effect(tmp_path):
    """display_cmd reproduces the reference's viewer side-effect
    (image_sink_impl.cc:66-69 shells '/usr/bin/display result.bmp &'):
    one detached process per written image, given the image path."""
    import sys
    import time as _time
    from gr_ldpc_ece535a_tpu.blocks import ImageSink

    bmp = bytes([0x42, 0x4D, 26, 0, 0, 0, 0, 0, 0, 0, 26, 0, 0, 0,
                 12, 0, 0, 0, 1, 0, 1, 0, 1, 0, 24, 0])
    out = tmp_path / "result.bmp"
    marker = tmp_path / "seen.py"
    marker.write_text(
        "import sys, pathlib\n"
        "pathlib.Path(sys.argv[1] + '.seen').write_text('x')\n")
    sink = ImageSink(out_path=str(out), verbose=False,
                     display_cmd=f"{sys.executable} {marker}")
    sink.work(np.frombuffer(bmp + bmp, np.uint8))  # 2nd header flushes 1st
    sink.stop()
    assert out.exists()
    for _ in range(100):                           # detached: poll briefly
        if (tmp_path / "result.bmp.seen").exists():
            break
        _time.sleep(0.05)
    assert (tmp_path / "result.bmp.seen").exists()
