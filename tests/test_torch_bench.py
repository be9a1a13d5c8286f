"""The port's bench tools against the JAX package's: the harness's stats,
tables and JSON, ``run_bench`` over a stub Service, the RTF gate,
``GPURuntime.generate_audio_staged`` against ``TPURuntime``'s and against
the port's own ``generate_audio`` (voiced and not), ``profile_synthesis``
over both packages' Services, the ``bench`` and ``stageprof`` subcommands,
and the micro-benchmark on the CPU. ``tiny_arch()``, temperature 0."""

import json

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu import bench as j_bench
from go_pocket_tts_tpu.bench.stageprof import profile_synthesis as j_profile
from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu.tts.service import PCMChunk as JChunk
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu_torch import bench as t_bench
from go_pocket_tts_tpu_torch import config as t_config
from go_pocket_tts_tpu_torch.bench import microbench
from go_pocket_tts_tpu_torch.bench.stageprof import profile_synthesis
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.tts.service import PCMChunk, Service, load_voice_conditioning
from torch_fixtures import ARCH, THREE_CHUNKS, build_models, j_tokenizer, t_tokenizer, tokenizer_bytes, tts_config, voice_files

RMS_BUDGET = 1e-3  # tests/test_torch_runtime.py's float32 budget for generate_audio
PCM16_STEP = 1.0 / 32767 + 1e-6  # generate_audio's int16 truncation, and float32 slack
TOKENS = [3, 17, 41, 9, 22]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors run on one CPU thread: beside the suite's other worker
    processes, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models(seed=21)


RUNS = {
    "warm": [j_bench.RunResult(0, 2.0, 1.0, 0.5, True), j_bench.RunResult(1, 0.5, 1.0, 0.1), j_bench.RunResult(2, 0.25, 1.0, 0.05)],
    "cold_only": [j_bench.RunResult(0, 1.5, 3.2, 0.2, True)],
    "silent": [j_bench.RunResult(0, 0.3, 0.0, 0.0), j_bench.RunResult(1, 0.2, 0.5, 0.01)],
    "even": [j_bench.RunResult(i, 0.1 * (i + 1), 2.0, 0.01 * i) for i in range(4)],
}


@pytest.mark.parametrize("case", list(RUNS))
def test_stats_table_and_json_match(case):
    j_runs = RUNS[case]
    t_runs = [t_bench.RunResult(r.run_index, r.synth_seconds, r.audio_seconds, r.ttfa_seconds, r.cold) for r in j_runs]
    j_stats, t_stats = j_bench.compute_stats(j_runs), t_bench.compute_stats(t_runs)
    assert t_bench.format_table(t_stats) == j_bench.format_table(j_stats)
    assert t_bench.format_json(t_stats) == j_bench.format_json(j_stats)
    for r, s in zip(t_runs, j_runs):
        assert (r.rtf, r.x_realtime) == (s.rtf, s.x_realtime)
    assert t_bench.calc_rtf(1.0, 0.0) == j_bench.calc_rtf(1.0, 0.0) == float("inf")
    for mod in (j_bench, t_bench):
        with pytest.raises(ValueError, match="no bench runs"):
            mod.compute_stats([])


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.375, 0.5])
def test_rtf_threshold_matches(threshold):
    runs = RUNS["warm"]
    outcome = []
    for mod in (j_bench, t_bench):
        stats = mod.compute_stats([mod.RunResult(r.run_index, r.synth_seconds, r.audio_seconds, r.ttfa_seconds, r.cold) for r in runs])
        try:
            mod.check_rtf_threshold(stats, threshold)
            outcome.append("ok")
        except RuntimeError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]
    assert (outcome[1] == "ok") == (threshold in (0.0, 0.375, 0.5))


def test_run_bench_over_a_stub_service():
    class Stub:
        def __init__(self, chunk):
            self.chunk, self.calls = chunk, []

        def synthesize_stream(self, text, voice_path=""):
            self.calls.append((text, voice_path))
            yield self.chunk(np.zeros(12000, np.float32), 0, False)
            yield self.chunk(np.zeros(24000, np.float32), 1, True)

    seen = []
    j_svc, t_svc = Stub(JChunk), Stub(PCMChunk)
    j_stats = j_bench.run_bench(j_svc, "hello", runs=2, voice_path="v")
    t_stats = t_bench.run_bench(t_svc, "hello", runs=2, voice_path="v", on_run=seen.append)
    assert t_svc.calls == j_svc.calls == [("hello", "v")] * 3
    assert [(r.run_index, r.cold, r.audio_seconds) for r in t_stats.runs] == [
        (r.run_index, r.cold, r.audio_seconds) for r in j_stats.runs
    ] == [(0, True, 1.5), (1, False, 1.5), (2, False, 1.5)]
    assert seen == t_stats.runs
    assert all(0 < r.ttfa_seconds <= r.synth_seconds for r in t_stats.runs)
    no_cold = t_bench.run_bench(t_svc, "hello", runs=1, include_cold=False)
    assert [r.cold for r in no_cold.runs] == [False]


def test_generate_audio_staged_matches_the_reference(models):
    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=20)
    want, j_stages = TPURuntime(jm, seed=1, frame_bucket=64).generate_audio_staged(TOKENS, JConfig(**kw))
    got, stages = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu").generate_audio_staged(TOKENS, GenerateConfig(**kw))
    assert list(stages) == list(j_stages) == ["prefill", "ar", "decode"]
    assert all(v > 0 for v in stages.values())
    assert got.dtype == np.float32 and got.shape == want.shape == (20 * 1920,)
    assert rms_delta(got, want) < RMS_BUDGET


STAGED_CFG = dict(temperature=0.0, eos_threshold=1e9, max_steps=8)


@pytest.fixture(scope="module")
def port_runtime(models):
    rt = GPURuntime(models[1], seed=1, frame_bucket=64, device="cpu")
    return rt, rt.generate_audio(TOKENS, GenerateConfig(**STAGED_CFG))


@pytest.mark.parametrize("voice", ["none", "embedding", "model_state"])
def test_staged_audio_is_generate_audio_within_one_pcm16_step(port_runtime, tmp_path, voice):
    rt, plain = port_runtime
    cfg = GenerateConfig(**STAGED_CFG)
    if voice != "none":
        load_voice_conditioning(voice_files(tmp_path)[voice]).apply_to(cfg)
    staged, _ = rt.generate_audio_staged(TOKENS, cfg)
    whole = rt.generate_audio(TOKENS, cfg) if voice != "none" else plain
    assert staged.shape == whole.shape == (8 * 1920,)
    assert np.abs(staged - whole).max() <= PCM16_STEP
    if voice != "none":
        assert np.abs(whole - plain).max() > 10 * PCM16_STEP  # the voice reached the prompt


def test_profile_synthesis_matches_the_reference_stages(models, tmp_path):
    jm, tm = models
    data = tokenizer_bytes()
    j_svc = JService(TPURuntime(jm, seed=1, frame_bucket=64), j_tokenizer(data), tts_config(JTTSConfig))
    t_svc = Service(GPURuntime(tm, seed=1, frame_bucket=64, device="cpu"), t_tokenizer(data), tts_config(t_config.TTSConfig))
    want = j_profile(j_svc, THREE_CHUNKS)
    got = profile_synthesis(t_svc, THREE_CHUNKS, trace_dir=str(tmp_path / "trace"))
    assert list(got.stages) == list(want.stages) == ["prepare", "prefill", "ar", "decode", "generate", "encode"]
    assert got.audio_seconds == want.audio_seconds == 3 * 6 * 0.08
    assert got.stages["generate"] >= got.stages["ar"] > 0 and got.rtf > 0
    trace = json.loads((tmp_path / "trace" / "stageprof.trace.json").read_text())
    assert got.trace_path.endswith("stageprof.trace.json") and trace["traceEvents"]
    assert got.format_table().splitlines()[0] == want.format_table().splitlines()[0]


def test_bench_and_stageprof_subcommands_on_the_cpu(tmp_path, monkeypatch, capsys):
    from go_pocket_tts_tpu_torch.cli.main import main
    from go_pocket_tts_tpu_torch.models import synthetic
    from go_pocket_tts_tpu_torch.utils.safetensors import write_file

    write_file(tmp_path / "model.safetensors", synthetic.build_checkpoint(ARCH, seed=3))
    (tmp_path / "tokenizer.model").write_bytes(tokenizer_bytes())
    for k, v in {
        "POCKETTTS_PATHS_MODEL_PATH": str(tmp_path / "model.safetensors"),
        "POCKETTTS_PATHS_TOKENIZER_MODEL": str(tmp_path / "tokenizer.model"),
        "POCKETTTS_MAX_STEPS": "4",
        "POCKETTTS_EOS_THRESHOLD": "1000000",
        "POCKETTTS_RUNTIME_SEED": "7",
        "POCKETTTS_PLATFORM": "cpu",
    }.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    assert main(["bench", "--text", "hello world", "--runs", "1", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == ["runs", "rtf_min", "rtf_mean", "rtf_max", "ttfa_p50_seconds"]
    assert [(r["run"], r["cold"], r["audio_seconds"]) for r in got["runs"]] == [(0, True, 0.32), (1, False, 0.32)]
    assert main(["bench", "--text", "hello world", "--runs", "1", "--no-cold", "--rtf-threshold", "1e-9"]) == 1
    assert "exceeds threshold" in capsys.readouterr().err
    assert main(["stageprof", "--text", "hello world", "--trace-dir", "tr"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in table[1:-1]] == ["prepare", "prefill", "ar", "decode", "generate", "encode"]
    assert table[-1].endswith("audio=0.32s") and (tmp_path / "tr" / "stageprof.trace.json").exists()


def test_microbench_on_the_cpu(capsys):
    assert microbench.main(["--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and len(lines) == 7
    assert all(" p50 " in line and " ms" in line for line in lines[1:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            microbench.main(["--reps", "1"])
