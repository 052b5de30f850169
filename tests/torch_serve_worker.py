"""One rank of the tensor-parallel decode engine in
tests/test_torch_serve_tp.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the JAX package meanwhile and compares.
Rank 0 of the ("model",) mesh is the engine's leader and runs the script
below (the JAX engine test's schedule, a chunked prefill, speculative
verify, a swap of the whole tree, then a server with a prefix cache,
chunked prefill and a checkpoint tailer); rank 1 runs ``follow()`` until
the server's stop.  Each rank pickles its results to
``<out_dir>/rank<r>.pkl``.
"""

import os
import pickle
import time

import torch
import torch.distributed as dist

from distlearn_tpu_torch.models.convert import lm_from_jax
from distlearn_tpu_torch.models.transformer import greedy_generate
from distlearn_tpu_torch.parallel.mesh import Mesh
from distlearn_tpu_torch.serve import DecodeEngine, ServeClient, ServeServer
from distlearn_tpu_torch.utils.checkpoint import save_checkpoint


def _stream(eng, prompt, max_new, chunk=None):
    """One request alone: its prefill (in ``chunk``-position passes when
    given), then ticks."""
    job = eng.begin(prompt, max_new)
    first = eng.prefill_step(job, chunk)
    while first is None:
        first = eng.prefill_step(job, chunk)
    toks = [first] + [eng.tick()[job.slot] for _ in range(max_new - 1)]
    eng.finish(job.slot)
    return toks


def _verify_stream(eng, prompt, max_new, guess):
    """One request advanced by ``verify`` only, drafting ``guess``'s next
    tokens at every round (right or wrong): the emitted stream must be the
    greedy one whatever the drafts; returns ``(tokens, rounds)``."""
    slot, first = eng.admit(prompt, max_new)
    toks, rounds = [first], 0
    while len(toks) < max_new:
        n = len(toks)
        emitted = eng.verify({slot: list(guess[n:n + eng.spec_k])})[slot]
        toks.extend(emitted)
        rounds += 1
    eng.finish(slot)
    return toks[:max_new], rounds


def _leader(eng, mesh, case):
    res = {}
    max_new = case["max_new"]
    # (1) tests/test_serve.py::test_engine_parity_tp_sharded's schedule
    slots = {}
    for i, p in enumerate(case["prompts"]):
        slot, first = eng.admit(p, max_new)
        slots[slot] = {"i": i, "toks": [first]}
    mesh.stats.reset()
    for j in range(max_new - 1):
        for slot, tok in eng.tick().items():
            slots[slot]["toks"].append(tok)
        if j == 0:
            res["tick_psums"] = mesh.stats.calls.get("psum", 0)
    res["parity"] = [None] * len(case["prompts"])
    for slot, st in slots.items():
        eng.finish(slot)
        res["parity"][st["i"]] = st["toks"]
    # (2) a chunked prefill, 3 positions a pass
    res["chunked"] = _stream(eng, case["long"], max_new, chunk=3)
    # (3) verify: drafts from the port's own single-rank greedy run, one
    # of them wrong, so that rounds accept some drafts and reject others
    whole = lm_from_jax(case["params"])
    guess = [int(t) for t in greedy_generate(
        whole, case["long"][None], case["verify_new"])[0]]
    guess[3] = (guess[3] + 1) % case["vocab"]
    res["verify"], res["verify_rounds"] = _verify_stream(
        eng, case["long"], case["verify_new"], guess)
    # (4) swap_params on the whole tree: the tree rides the channel
    eng.swap_params(case["params2"])
    res["swapped"] = _stream(eng, case["prompts"][0], max_new)
    eng.swap_params(case["params"])
    res["swapped_back"] = _stream(eng, case["prompts"][0], max_new)
    # (5) the server: a cached shared prefix, chunked prefill, then an
    # epoch-fenced hot swap from a checkpoint each follower reads itself
    srv = ServeServer(eng, idle_wait=0.005, prefix_cache=True,
                      prefill_chunk=case["prefill_chunk"],
                      ckpt_dir=case["ckpt_dir"], ckpt_poll=0.02, epoch=1)
    srv.start()
    try:
        with ServeClient(srv.host, srv.port) as c:
            res["served"] = [c.generate(p, max_new, rid=f"s{i}",
                                        timeout=120)
                             for i, p in enumerate(case["shared"])]
            save_checkpoint(case["ckpt_dir"], 1, case["params2"],
                            metadata={"epoch": 2})
            deadline = time.monotonic() + 60
            while srv.epoch != 2:
                assert time.monotonic() < deadline, "the swap never landed"
                time.sleep(0.01)
            res["served_after_swap"] = c.generate(case["prompts"][0],
                                                  max_new, rid="after",
                                                  timeout=120)
        res["health"] = srv.health()
    finally:
        srv.stop()            # sends the followers' stop op
    return res


def run(rank, world, store_path, case, out_dir):
    torch.set_num_threads(1)     # the ranks and the parent share the cores
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store_path, world))
    try:
        mesh = Mesh((world,), ("model",), device="cpu")
        eng = DecodeEngine(case["params"], num_slots=2,
                           max_len=case["max_len"], page=8, mesh=mesh,
                           tp_axis="model", device="cpu")
        res = {"heads": eng.heads, "pool": tuple(eng._k.shape),
               "leader": eng.is_leader}
        if eng.is_leader:
            res.update(_leader(eng, mesh, case))
        else:
            res["ops"] = eng.follow()
            res["stopped"] = True
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(world, case, out_dir, meanwhile=None, timeout=240):
    """Run the ranks; ``meanwhile()`` runs in this process while they do
    and its result comes back beside the ranks' results."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, f"{out_dir}/store",
                                           case, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ref = meanwhile() if meanwhile is not None else None
    finally:
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(5)
    assert not alive, f"ranks still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(f"{out_dir}/rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, ref


def _lose_leader(rank, world, store_path, case, out_dir):
    """Rank 0 leads one prefill and then exits without a stop op; rank 1
    records how its ``follow()`` ended."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store_path, world))
    mesh = Mesh((world,), ("model",), device="cpu")
    eng = DecodeEngine(case["params"], num_slots=1, max_len=case["max_len"],
                       page=8, mesh=mesh, tp_axis="model", device="cpu")
    if eng.is_leader:
        eng.admit(case["prompts"][0], 2)
        os._exit(0)           # dies: no stop, no group teardown
    t0 = time.monotonic()
    try:
        eng.follow()
        how = "returned"
    except ConnectionError as e:
        how = type(e).__name__
    with open(os.path.join(out_dir, "follower.pkl"), "wb") as f:
        pickle.dump({"how": how, "seconds": time.monotonic() - t0}, f)
    os._exit(0)


def spawn_lost_leader(case, out_dir, timeout=120):
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_lose_leader,
                         args=(r, 2, f"{out_dir}/store", case, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(5)
    assert not alive, f"a rank still ran after {timeout} s"
    with open(f"{out_dir}/follower.pkl", "rb") as f:
        return pickle.load(f)
