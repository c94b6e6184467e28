"""The serving engine's captured decode step on the card
(llmc_tpu_torch.serve.engine, serve/graphs.py): the tokens of the graph's
replays equal the eager step's, greedy and sampled, single steps and
K-step windows, int8 and bf16 caches, in each serving mode (W4A16 +
flash, W4A8 + batch, W8A16 + flash); the launch counters count what the
host launched, and the profiler counts a replay's kernels on the device;
and a replay after a larger eager decode elsewhere on
the card (which regrows the decode kernels' split workspace) still gives
the same tokens.  The model is a 2-layer Llama at widths the kernels take
(every linear a kernel, ``xla_branch_calls`` 0).  Every test needs the
card and skips without one."""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device  # noqa: F401

# two layers at widths every kernel takes: group-pair half groups of 64
# columns at K = 256 and 512, heads of 64 (2 query heads a kv head)
CARD_TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=64, dtype='bfloat16')
MODES = ('w4a16', 'w4a8', 'w8a16')
KV = {'int8': dict(method='naive', bit=8), 'bf16': dict(method='fp')}


def _requests(n=6, seed=0):
    from llmc_tpu_torch.serve import Request
    rng = np.random.RandomState(seed)
    return [Request(uid=i, prompt_ids=rng.randint(0, 256, (int(p),)),
                    max_new_tokens=int(6 + (i * 5) % 11))
            for i, p in enumerate(rng.randint(3, 60, n))]


def _engine(model, qmap, dev, kv='int8', K=1, temperature=0.0,
            eager=False):
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      ServingEngine)
    return (EagerServingEngine if eager else ServingEngine)(
        model, qmap=qmap, max_batch=4, max_len=256,
        prefill_buckets=(16, 64), seed=3, temperature=temperature,
        top_p=0.9, kv_policy=KVCachePolicy(**KV[kv]),
        decode_steps_per_sync=K, device=dev)


def _serve(eng, reqs=None):
    """Tokens, launch counts and XLA-branch calls of one run."""
    from llmc_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                    xla_branch_calls)
    reqs = reqs or _requests()
    reset_launch_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    assert all(r.done and len(r.output_ids) == r.max_new_tokens
               for r in reqs)
    return ([r.output_ids for r in reqs], launch_counts(),
            xla_branch_calls())


@pytest.fixture(scope='module')
def models():
    """The three serving modes' random packed models, built on first
    use (on the card only)."""
    built = {}

    def get(mode, dev):
        if mode not in built:
            import chip_smoke
            built[mode] = chip_smoke.make_model(mode, CARD_TINY, dev)
        return built[mode]
    return get


@pytest.mark.gpu
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kv', ['int8', 'bf16'])
@pytest.mark.parametrize('temperature', [0.0, 0.8])
@pytest.mark.parametrize('K', [1, 4])
def test_graph_tokens_equal_eager_on_card(cuda_device, models, mode, kv,
                                          temperature, K):
    """The same requests through the captured step and through the eager
    step give the same tokens (and K-step windows those of single steps);
    the eager run launched every step's kernels, the graph run those of
    its prefills and of each graph's eager first run and capture; no call
    runs the XLA branch, and the step did replay its graph."""
    import chip_smoke
    model, qmap = models(mode, cuda_device)
    L = CARD_TINY['num_hidden_layers']
    with chip_smoke.attn_impl(chip_smoke.MODES[mode].attn):
        ref = _engine(model, qmap, cuda_device, kv, K, temperature,
                      eager=True)
        assert not ref.graphed
        eager = _serve(ref)
        eng = _engine(model, qmap, cuda_device, kv, K, temperature)
        assert eng.graphed
        graph = _serve(eng)
        single = _serve(_engine(model, qmap, cuda_device, kv, 1,
                                temperature))
    assert graph[0] == eager[0]
    assert graph[0] == single[0]
    steps = ref.stats['decode_steps']
    assert eager[1] == chip_smoke.expected_launches(
        L, ref.stats['prefill_forwards'] + steps, steps, mode)
    host = chip_smoke.host_decode_steps(eng)
    assert graph[1] == chip_smoke.expected_launches(
        L, eng.stats['prefill_forwards'] + host, host, mode)
    assert graph[2] == eager[2] == 0
    assert sum(s.replays for s in eng._graphs.values()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize('mode', MODES)
def test_graph_launch_counts_follow_replays_on_card(cuda_device, models,
                                                    mode):
    """Once the step is captured, the profiler counts on the device the
    port's kernels of N replays and of the prefills between them (one
    decode attention a layer a step, four block linears a layer and the
    head a forward), as ``chip_smoke.expected_launches`` says, while the
    wrappers' counters hold the prefills' launches alone."""
    import chip_smoke
    from llmc_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                    xla_branch_calls)
    model, qmap = models(mode, cuda_device)
    L = CARD_TINY['num_hidden_layers']
    with chip_smoke.attn_impl(chip_smoke.MODES[mode].attn):
        eng = _engine(model, qmap, cuda_device)
        reqs = _requests()
        for r in reqs:
            eng.submit(r)
        eng.step()                   # the eager first run, then capture
        assert list(eng._graphs) == [1] and eng._graphs[1].replays == 0
        before = dict(eng.stats)
        reset_launch_counts()
        with chip_smoke.device_profile() as prof:
            eng.run([])
        counts, xla = launch_counts(), xla_branch_calls()
    assert all(r.done for r in reqs)
    pre = eng.stats['prefill_forwards'] - before['prefill_forwards']
    steps = eng.stats['decode_steps'] - before['decode_steps']
    assert pre > 0 and steps > 0
    assert eng._graphs[1].replays == steps
    device = chip_smoke.profiled_kernel_calls(prof)
    want = chip_smoke.expected_launches(L, pre + steps, steps, mode)
    assert device == {k: want[k] for k in device}
    assert counts == chip_smoke.expected_launches(L, pre, 0, mode)
    assert xla == 0


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['w4a16', 'w4a8'])
def test_graph_replays_after_a_larger_eager_decode_on_card(cuda_device,
                                                           models, mode):
    """The scratch-lifetime trap: an engine captures its step, a larger
    decode then runs eagerly elsewhere on the card and regrows the decode
    kernels' split workspace and arrival counters (freeing the buffers the
    graph's kernels point at), new tensors full of junk take the freed
    memory, and the engine's later replays still give the eager step's
    tokens."""
    import chip_smoke
    from llmc_tpu_torch.ops import flash_decode as FD
    dev = cuda_device
    model, qmap = models(mode, dev)
    with chip_smoke.attn_impl(chip_smoke.MODES[mode].attn):
        want = _serve(_engine(model, qmap, dev, eager=True))[0]
        eng = _engine(model, qmap, dev)
        reqs = _requests()
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        assert eng._graphs, 'the step was captured'
        old = dict(FD._SCRATCH[torch.device('cuda', dev.index or 0)])
        q, kb, vb, ks, vs = chip_smoke.flash_inputs(dev, 8, 4096, 32, 32,
                                                    128, cache='int8')
        pos = torch.full((8,), 4000, dtype=torch.int32, device=dev)
        FD.flash_decode_cuda(q, kb, vb, ks, vs, pos, 1)
        FD.decode_scratch(q.device, 4 * old['work'].numel(),
                          4 * old['arrivals'].numel())
        new = FD._SCRATCH[q.device]
        assert new['work'].data_ptr() != old['work'].data_ptr()
        assert new['arrivals'].data_ptr() != old['arrivals'].data_ptr()
        del old, q, kb, vb, ks, vs
        junk = [torch.full((n,), 7777, dtype=torch.int32, device=dev)
                for n in (1 << 16, 1024) for _ in range(16)]
        eng.run([])
        torch.cuda.synchronize()
        del junk
    assert [r.output_ids for r in reqs] == want
