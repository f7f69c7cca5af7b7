"""Quickest proof that the PyTorch/CUDA port builds and serves on the card.

    python3 chip_smoke.py

Runs from the root of a checkout, on one CUDA device, in phases; any
failure raises (exit code != 0).

1. build: the CUDA kernels of ``src/repro_torch/csrc`` are built from
   source (one nvcc per file, in parallel) and loaded; the SASS of the
   int8 tile body must hold TMA loads, mbarrier waits and wgmma.
2. kernels: each kernel against its plain PyTorch version at the llama-7b
   shapes the serving path gives it (plus kv16/kv8/kv4, GQA, ragged-length
   and page-16 cases, and decode over a 2048-position context in both
   layouts), with the error beside its stated tolerance, the
   kernel's time, the plain version's time, one PyTorch library call's time
   as a yardstick (the port never calls it) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type).  Times are CUDA-event medians with the 50 MB L2 flushed
   before every launch, since the serving path finds each weight cold.
   A call whose host enqueue outlasts the flush is timed with the card
   waiting for it; for w4a8_matmul, int8_matmul and w8a8_matmul the log
   line also gives the time with the enqueue hidden behind a device sleep
   (the call's device work alone) and the host's enqueue per call; for
   the int8 pair also the device work alone after a flush that leaves the
   L2 clean.  Each paged kernel must equal its linear kernel bit for bit on the same
   contents, a one-token chunk must equal decode, and a chunk split in two
   must equal the whole chunk, in every format and both layouts;
   w4a8_matmul must equal its plain version bit for bit at the four
   llama-7b linear shapes, and its rows and dequant_matmul's must be the
   same at M = 4 as in the M = 512 product.  Where PERF.md records the
   time of a case before its kernel was redesigned, the log line shows it
   beside the new one.
   int8_matmul and w8a8_matmul at the four llama-7b linear shapes and the
   512-token 4096 -> 4096 product, and quantize_pack at the llama-7b weight
   shapes (w4 g128 both ways, w2, w8 and per-channel w4) and opt-125m's
   768 x 3072 w4 g128, must equal their plain versions bit for bit; the int8 pair's rows at M = 4 must equal
   the same rows at M = 512, and each log line names the body of
   csrc/int8_matmul.cu that ran (decode, wgmma or mma_sync).
   opt-125m's shapes too: w4a8_matmul at M = 4 and 512 for 768 -> 768,
   768 -> 3072 and 3072 -> 768 (bit for bit, rows equal across M),
   dequant_matmul at M = 4 and 512 for 768 -> 3072, the four attention
   kernels at B 4, Hkv 12, D 64, kv8 and kv4, length 144, and one kv4
   decode case at D 32 in each layout (the value-by-value copy path).
   The dense registry's attention shapes: the four attention kernels at
   kv16, kv8 and kv4 for (D, G, Hkv) = (128, 3, 8) phi4-mini, (128, 5, 8)
   qwen2.5-14b, (160, 4, 8) stablelm-12b (the value-by-value copies at
   D % 64 != 0) and (256, 8, 1) gemma-2b (MQA, the largest shared-memory
   request), and the MoE registry's (128, 8, 4) qwen3-moe-30b-a3b and
   (128, 6, 8) dbrx-132b, each against its plain version and the paged
   kernels bit for bit against the linear ones.  The MoE archs'
   attention linears: w4a8_matmul at M = 4 and 512 for qwen3-moe's 2048 ->
   4096, 2048 -> 512 (the narrowest N any phase runs) and 4096 -> 2048
   and dbrx's 6144 -> 6144 and 6144 -> 1024 (bit for bit, rows equal
   across M), dequant_matmul at 2048 -> 512, and quantize_pack at their
   weight and expert shapes (2048 x 4096, 2048 x 512, 4096 x 2048, 2048
   x 768, 768 x 2048, 6144 x 10752, 10752 x 6144).  The quantized vlm and
   audio archs' linears: w4a8_matmul and dequant_matmul at M = 4 and 512
   for hubert-xlarge's 1280 -> 1280, 1280 -> 5120 and 5120 -> 1280 and
   paligemma-3b's 2048 -> 2048, 2048 -> 256, 2048 -> 16384 and 16384 ->
   2048 (w4a8 bit for bit, rows equal across M), quantize_pack at those
   weight shapes, and the four attention kernels at hubert's Hkv 16, G 1,
   D 80 (kv16 and kv8: 32 does not divide 80, so kv4 is refused there);
   paligemma's attention is gemma-2b's.  Every quantize_pack line also
   gives the call's device work alone (beside PERF.md's time of the
   kernel before its redesign and the timing floor, a one-element fill
   timed the same way), and qwen3-moe's 128 experts of 2048 x 768 g128
   packed in one launch must equal 128 single calls byte for byte.  Every
   dequant_matmul line names the body that ran (decode, or the tile body
   with its tile and the number of blocks K is cut across) and gives its
   time as a multiple of torch.matmul's; at M = 512 the rows at M = 4
   (decode) and M = 64 must equal the same rows of the M = 512 product.
   Slice identity (a rank of a (1, m) mesh runs each kernel on its slice):
   w4a8_matmul (w4 g128 a4) and dequant_matmul (w4 g128) at M = 4 and 512
   on contiguous column slices N / 2 and N / 4 of llama-7b's 4096 -> 4096
   and 4096 -> 11008 weights (5504 and 2752 columns are ragged) must equal
   the same columns of the full product, and the four attention kernels
   (kv8 and kv4, both layouts) on head slices of q and of the cache
   (llama-7b's 32 KV heads, qwen2.5-14b's 8 with G 5) the same heads of
   the full call, bit for bit (no timing).
3. serve: llama-7b at full width, W4A4 g128 with the kv8 cache, greedy,
   through ``repro_torch.launch.serve`` (4 requests, prompt 128, 32 new
   tokens, batch 4, max_len 512), with the launch counters zeroed just
   before and read just after; then a teacher-forced check of the same
   tokens against the plain versions on the card.  The served tree's RTN
   packing at startup runs the quantize_pack kernel (224 launches, one a
   linear, counted on the main path).
4. serve at a16: W4A16 g128 with the fp cache (depth cut), which runs
   dequant_matmul.
5. serve phase 3's model and requests over page pools of 64: (a) with
   whole-prompt admission into an automatic pool, whose streams must equal
   phase 3's token for token; (b) with chunks of 64 into a 10-page pool
   (the working set needs 12), which must preempt, complete every request
   and pass the per-block teacher-forced check over pages.
6. serve the same model at kv4 (4 requests x (128 + 8), paged, chunks of
   64), gated by the same per-block check.
7. repack: the reference's entry points of the int8 pair, which no
   serving path runs (``ops.w8a8_matmul``, ``int8_matmul.int8_matmul``;
   no serving path of the reference runs them either), and of
   ``ops.quantize_pack``, at full width over every layer of the served
   tree.  Each
   layer's float block is drawn again on the card from the generator
   sequence that built phase 3's tree, and ``ops.quantize_pack`` (w4 g128)
   of each of its seven linears must equal the QTensor phase 3 served and
   the plain ``quantize_codes``, packed bytes, scales and zero points (224
   launches, a check that the summary does not count); ``wq`` and ``w_up``
   as symmetric per-channel int8 codes go through ``ops.w8a8_matmul`` and
   ``int8_matmul`` at M = 4 and 512 on phase 3's prompt embeddings, bit for
   bit against the plain version; then one call of each at each M under
   torch.profiler must run one kernel (int8_matmul) or two (w8a8_matmul:
   the pre-pass and the product) and return the plain version's bits; a
   trace whose device records the profiler lost (its CPU side holds the
   launch) is taken again, up to 5 times, and counted in the summary's
   ``profiler_retries``.  Phase 7 runs while no other process of the
   script shares the card.
8. calibrate: AffineQuant calibration of llama-7b-width blocks on the
   card (depth cut to 2 layers; 32 x 512 Markov tokens, batch 8, 3 epochs,
   alpha 0.1) through ``repro_torch.launch.calibrate``, then serving of the
   packed tree: (a) W4A4 g128 kv8 with diagonal norm sites (merged into the
   norms, which gain a bias) and 32 headwise vo transforms, through
   w4a8_matmul; (b) W4A16 g128 kv16 with full 4096 x 4096 norm sites under
   the gradual mask, kept as explicit activation factors, through
   dequant_matmul.  Gates: every epoch loss finite and each block's last
   below its first; every full and headwise effective matrix strictly
   diagonally dominant (margin > 0); the packed tree written by
   ``checkpoints.save`` and read back by ``load_tree`` byte for byte;
   ``serve --load-packed`` on that directory gives the in-memory tree's
   greedy streams (4 requests x (128 + 32)); the kernel path against the
   plain versions (a: the per-block check, b: phase 4's end-to-end check);
   and for (b) the packed tree's teacher-forced logits against the
   fake-quant tree through the float forward within FAKE_TOL.  Logs the
   median step time, peak memory, perplexities and the phase's wall time.
9. the Engine contract on phase 3's tree (pages and chunks of 64, run
   after phase 6 while the tree is resident), through ``Engine.submit`` /
   ``run``: (a) prefix sharing: 4 requests share a 320-token system prompt
   and add 64-token suffixes (32 new tokens each); a cold and a replay wave
   on one engine whose pool holds the trace (4 x 7 pages) must give the
   no-sharing paged engine's streams token for token, the replay 4 of 4
   hits with 320 tokens matched each (5 of 6 full pages: one token stays
   novel) and 256 prefilled, ``verify()`` after each wave, and a blake2b
   digest of every registered page's pool bytes unchanged from
   ``register_prefix`` to the drain; then the per-block check over a
   prefix-resumed chunk on the adopted pages.  (b) the failure model: a
   writer completes, three readers adopt its prompt pages at once, a NaN
   is injected into one reader mid-decode; every reader ends FAILED_NAN
   (each co-reader naming the reader whose quarantine failed it), the
   writer COMPLETED, each partial stream a prefix of its no-sharing
   stream, a late resubmission re-prefills (0 tokens matched) to the
   no-sharing stream, the pool conserved under integrity checks; one short
   trace each for a deadline, a raising callback, cancel when queued,
   mid-prefill and decoding, and allocator faults (3, and forever: the
   watchdog) with the survivors equal to the unfaulted run; and, reported
   only, whether a NaN left in an unscrubbed recycled page reaches its
   next tenant through the paged decode kernel and its plain version.  (c)
   sampling: phase 3's requests at temperature 0.8, top-k 40, seed 0 over
   the linear engine (twice) and phase 5b's 10-page pool must give equal
   streams, the pool must preempt, top-k 1 must give phase 3's greedy
   streams and the sampled streams must differ from them.  Each part logs
   its wall time and each wave its tokens/s beside the card's name and
   power limit.
10. opt-125m at full width and depth (12 layers, d 768, 12 heads of 64,
   d_ff 3072, vocab 50272, sinusoidal positions), random seeded float
   weights, phase 8's tokens and budgets: (a) AffineQuant W4A4 g128 kv8
   (diagonal LayerNorm sites whose shifts merge into the norms' biases and
   the q/k/v and fc1 biases, 12 headwise vo sites) with phase 8's gates,
   then the packed tree over the linear kv8 cache, over pages and chunks
   of 64 into a 10-page pool (the working set needs 12), which must
   preempt and give the linear streams token for token, and at kv4 paged,
   each with the per-block check; (b) AffineQuant W4A16 g128 with full
   768 x 768 sites, through dequant_matmul, packed vs fake-quant logits
   within FAKE_TOL; (c) the RTN, AWQ and GPTQ baselines at W4A16 g128 on
   opt-125m and on phase 8's two llama-7b-width blocks: finite
   perplexities, AWQ's layer-output MSE at most RTN's on every linear,
   GPTQ's summed over each block below RTN's, RTN's packed tree (through
   quantize_pack) byte-equal to quantize_codes and dequantizing bit for
   bit to the fake-quant tree, served through dequant_matmul and held end
   to end against the plain versions.  Logs the perplexities side by side
   and each method's seconds per block.  (d) the float opt-125m tree served
   through the float ``Model`` as phase 11 serves llama-7b's.
11. float llama-7b at its published width and depth (32 layers, d 4096,
   26.43 GB of float32 weights), seed 0 (the floats phase 3 packed), phase
   3's requests through ``launch/serve.py --fp``: float32 linears
   (``torch.matmul``, no TF32) and a float cache read by the kv16 attention
   kernels, served over the linear cache, over pages of 64 (streams equal
   the linear ones token for token), with chunks of 64 and over phase 5b's
   10-page pool (must preempt).  A row of ``torch.matmul`` is not the same
   bits at every row count (``launch/row_probe.py``, logged here), so the
   chunked and preempted streams are held to the logits: teacher-forced on
   each stream, the chunked prefill's logits within FLOAT_TOL of the whole
   prompt's and every served token within FLOAT_TOL of the whole-prompt
   path's greedy choice; teacher-forced kernel logits within FLOAT_TOL of
   the plain versions'.  Logs tokens/s, the decode step median, the
   weight bytes and the greedy agreement with phase 3's W4A4 streams
   (random weights: reported, not gated).
12. the dense registry at published widths: phi4-mini-3.8b, qwen2.5-14b,
   stablelm-12b and gemma-2b, each W4A4 g128 kv8 from seeded random
   weights packed layer by layer at startup (quantize_pack), served over
   the linear cache and pages of 64 (streams equal) with the per-block
   check; gemma-2b also float at full width and depth (linear == paged,
   kernels vs plain); and llama-7b W3A16 g128 (depth cut to 8 layers),
   whose matmuls run the plain dequant by design (no w3 kernel, as in the
   reference), held end to end against the plain attention.
13. training (no kernel of its own: float32 ``torch.matmul`` and
   autograd, as the reference trains through XLA): (a) opt-125m at
   published width and depth through ``repro_torch.launch.train`` (200
   steps of 16 x 128 tokens, checkpoints every 100, seed 0), with every
   loss finite and the last 20 losses' mean 1 nat below the first; the
   same command started as a subprocess, killed (SIGKILL) once step 100
   is saved and launched again unchanged must restore step 100 and save a
   step-200 checkpoint within 1e-5 of each leaf's largest magnitude of
   the uninterrupted run's (deterministic algorithms stay off: the log
   counts the bit-equal leaves); ``launch/calibrate --ckpt`` must read
   the floats the run trained (the same held-out perplexity); (b)
   llama-7b widths at depth 2 (cut from 32: 16 B a parameter of params,
   gradients and two moments), 10 steps, then one step in two
   microbatches and one under remat held to the plain step (loss and
   every leaf within 1e-5); step time, tokens/s and peak memory beside
   6 x params x tokens / 67 TFLOP/s for both; (c) llama-mini and
   opt-mini trained 800 steps as ``benchmarks/common.py`` trains them
   (held-out perplexity below half the vocab), then fp, RTN, AWQ, GPTQ,
   OmniQuant-diag and AffineQuant at W4A16 and W2A16 per channel and
   RTN, OmniQuant-diag and AffineQuant at W4A4 on each trained tree
   (table1 / table3's budget: 8 epochs, 16 x 96 tokens, alpha 0.1): a
   held-out perplexity table, AffineQuant's W2A16 output MSE below RTN's
   and at most 1.02x OmniQuant-diag's, its W4A4 perplexity below 10x
   fp's (``tests/test_system.py``'s gates); then trained opt-mini's
   AffineQuant W4A4 g128 kv8 packed tree served through the Engine
   (``w4a8_matmul``, ``flash_prefill``, ``flash_decode``; the per-block
   check) beside the trained float tree (greedy agreement logged).
   (a)'s kill and relaunch and (c)'s opt-mini run in processes of their
   own beside (c)'s llama-mini (the card is shared then: (c)'s timings
   are not those of one process alone).
14. the MoE family (the experts run on float activations: dequantized
   from their codes to float32 every step and multiplied by torch.bmm, the
   reference's one float-activation site; routing flips between the
   kernel and plain paths are counted in every per-block check and gated
   at MOE_FLIP_SHARE): (a) qwen3-moe-30b-a3b W4A4 g128 kv8 at published
   width and depth (48 layers, 128 experts top-8), seed-0 weights packed
   layer by layer at startup (336 quantize_pack launches, one a linear,
   a layer's 128 experts of a projection in one), phase 3's requests over
   the linear cache with the per-block check; then phase 17 (c) on this
   tree; then, the tree cut to 8 layers (MOE_LATER_LAYERS, full width: the
   script's time), pages of 64 (streams equal 17c's unsharded linear
   streams at that depth: whole-prompt admission prefills the same rows in
   both layouts, so the per-call expert capacities match), chunks of 64
   into a 10-page pool (must preempt and complete; capacity competes per
   chunk, so its streams are logged, not held) and kv4 paged with the
   per-block check; tok/s and the decode step beside the
   packed bytes' stream time, weight / KV bytes and peak memory; (b) the
   float qwen3-moe at published width, depth cut to 8 (22.43 GB), linear
   == paged, the per-block check of the kv16 kernels; (c) AffineQuant
   W4A4 and W4A16 of two of its layers with phase 8's budget and gates
   (the ln_mlp site transforms the router and every expert; at W4A16 the
   packed tree against the fake-quant tree through the float Model on the
   same calls); (d) training at its widths at depth 2, 10 steps of 16 x
   128 tokens against 6 x active params x tokens / 67 TFLOP/s, one step
   under remat held to the plain step, and one in two microbatches held
   to the mean of the plain losses of its halves (capacity raised so no
   token drops); (e) dbrx-132b W4A4 g128 kv8 at published width, depth
   cut to 4 (LayerNorm, 16 experts top-4, untied head), linear == paged
   and the per-block check.  Each part logs its wall time.
15. the recurrent families and the vlm / audio float paths, float32 at
   published width (seeded init): (a) mamba2-1.3b (48 SSD layers) and (b)
   recurrentgemma-2b (26 layers: RG-LRU blocks, a 2,048-position window
   attention block in three) through the Engine on the linear cache,
   prompts of 128, 128, 96 and 96 tokens (two exact-length prefill
   groups) and 32 new each, recurrentgemma also one 2,040-token prompt
   whose ring buffer wraps during decode (its prefill through
   flash_prefill, its decode through flash_decode over the ring); tok/s,
   the decode step beside the weights' stream time and peak memory;
   prefill(T) + one decode step against forward(T + 1), every request's
   served logits (teacher-forced) against the whole-sequence (windowed)
   forward within 1e-4 of the largest logit, and every request served
   alone: both its streams the forward's greedy choice or tied within
   1e-4; (c) paligemma-3b: 256 seeded prefix embeddings + 128 text tokens
   prefilled under the prefix-LM mask and 32 decode steps through
   flash_decode against the forward, then the Engine on text prompts; (d)
   hubert-xlarge's bidirectional forward and frame loss on 4 x 512 frames
   against 2 x params x frames / 67 TFLOP/s, its decode paths refused;
   (e) training mamba2-1.3b and recurrentgemma-2b at depth 2 through
   launch/train (remat, their microbatches): step time against 6 x params
   x tokens / 67 TFLOP/s, the loss on the next batch below the init's.
   Phase 2 also holds flash_decode and flash_prefill at recurrentgemma's
   attention shape (Hkv 1, G 10, D 256): decode over the wrapped ring of
   2,048 slots at B 4 and at B 48 (row tiles 4 + 4 + 2), prefill of 128-
   and 2,040-token chunks.
16. quantized vlm and audio, as the reference quantizes and serves them
   (token trunks; packed hubert is causal, its calibration bidirectional):
   (a) paligemma-3b W4A4 g128 kv8 at published width and depth (18
   layers, MQA of 8 heads of 256, GeGLU d_ff 16,384, a tied 257,216-token
   head), seed-0 weights RTN-packed layer by layer at startup (126
   quantize_pack launches, one a linear, counted and gated), phase 3's
   requests over the linear cache, pages of 64 (streams equal the linear
   ones) and chunks of 64 into a 10-page pool (must preempt and
   complete), then kv4 paged, each with the per-block check; tok/s and the
   decode step beside the weight-stream bound, weight / KV bytes, peak
   memory; (b) hubert-xlarge W4A4 g128 at 48 layers (16 heads of 80,
   LayerNorm, GELU, vocab 504), the same runs at kv8 and kv16, kv4
   refused (gated), and a causality gate: changing token 5 of a prompt
   leaves positions 0-4 of the packed logits bit for bit and moves
   position 6; (c) AffineQuant W4A4 g128 kv8 of two layers of each arch
   at published width with phase 8's budget and gates (losses falling,
   dominance margins, the checkpoint round trip, served with the per-block
   check), one hubert calibration step on the card held to the CPU's
   (loss within 1e-5, gradients within 1e-4) with its forwards
   bidirectional, and RTN / AWQ / GPTQ at W4A16 g128 on one block of each
   with phase 10's gates and their seconds per block; (c) runs in a
   process of its own beside (a) and (b) (the card is shared then).  Each
   part logs its wall time.
17. mesh-native serving on phase 3's tree (run after phase 9): (a)
   ``Engine(mesh=make_serving_mesh(1, 1))`` over NCCL with a world of one,
   phase 5a's requests (pages of 64, whole prompts): streams equal phase
   5a's token for token, ``memory_report`` the unsharded bytes on one
   device; (b) a (1, 2) mesh of two ranks on the one card over gloo
   (collectives staged through the host), started by ``launch/serve
   --mesh-data 1 --mesh-model 2 --share-cards`` on phase 3's tree cut to
   MESH_LAYERS (full width; saved once with ``checkpoints.save``, each
   rank loading it with ``--load-packed`` and cutting its shard) with phase
   5b's pool (chunks of 64, 10 pages): each rank's streams, statuses and
   preemptions must equal the unsharded engine's on the same tree and
   depth (which must preempt), each rank must hold less weight and KV
   bytes and launch the kernels (its launches by name and its decode step
   in the log line, beside the card's name and power limit); a rank that
   fails fails the script.  (c), run inside phase 14 on its tree cut to 8
   layers (full width, saved once): qwen3-moe-30b-a3b W4A4 g128 kv8 through
   ``launch/serve``'s serving run with ``--load-packed --mesh-model 2
   --share-cards`` on two ranks sharing the card, each holding 64 of every
   layer's 128 experts (only those dequantized), phase 14's requests over
   the linear cache: a single torch.bmm over 64 experts is not the same
   bits as over 128 at a decode step's capacity (``launch/row_probe
   --batches``), but the MoE multiplies experts in blocks of 32 (E / 4),
   so every
   rank's streams and statuses must equal one device's, its teacher-forced
   logits lie within 1e-4 of them and no routed row's top-k differs; a
   rank's expert count, weight bytes and one layer's expert dequantization
   (all 128 experts against a rank's 64) logged.  (d) mamba2-1.3b (8
   layers) and recurrentgemma-2b (6) float at full width through the same
   serving run with ``--fp`` on (1, 2): a rank holds half the SSD heads /
   rnn channels and their states, teacher-forced logits within 1e-4 of
   one device's, greedy agreement counted; (e) paligemma-3b float (6
   layers, full width) on (1, 2) through ``Engine(mesh=...)``: the prefill
   of 256 prefix slots and 128 text tokens and 31 teacher-forced decode
   steps within 1e-4 of one device's.  (c)'s ranks run beside phase 14
   (a)'s later runs and (d)-(e)'s beside phase 11, so those
   timings share the card.  Depths cut for the script's time (PERF.md
   section 4).
18. training the dense trunk on a mesh (no kernel of its own, as phase
   13; llama-7b widths at depth 2, phase 13(b)'s, 4 x 256 tokens a step,
   3 steps from the seed-0 init): (a) the steps on a 1 x 1 mesh (NCCL, a
   world of one) bit for bit those of 13(b)'s plain step; (b) two ranks
   sharing the card over gloo (every collective staged through the host)
   at (1, 2) and at (2, 1) (FSDP over "data", tensor parallelism over
   "model"): the first step's loss, grad norm and every leaf within 1e-5
   of the unsharded step's (each leaf's largest magnitude), the later
   losses and leaves within 1e-4 (a parameter element whose gradient
   nearly cancels, within the learning-rate budget), the replicated leaves
   bit-equal on both ranks, each rank's parameter and moment bytes below
   one device's; (c) (2, 1) with the int8 gradient reduction
   (``make_int8_psum``): finite losses logged beside the float mean's;
   step time, tokens/s and peak memory beside 6 x params x tokens / 67
   TFLOP/s for every run; (d) ``python -m torch.distributed.run
   --nproc-per-node 2 -m repro_torch.launch.train --arch opt-125m --mesh
   host`` (published width and depth, 20 steps of 16 x 128 tokens, two
   ranks sharing the card): rank 0 alone prints the final line and
   writes the whole checkpoint, which ``launch/calibrate --ckpt`` reads,
   its held-out fp perplexity below the seed-0 init's.  (b)-(d) run in
   processes of their own, (d) after (b)-(c), and (a) after them (the
   script stops (d) with SIGTERM, which ``torch.distributed.run``
   forwards to its workers).
19. summary.  Every kernel's ``launches`` is the count of the runs above
   that drive the main path (the startup packing of phases 3, 4, 12, 14
   and 16, phases 3-6, 9, 11, 12, phase 17's serving runs (each rank's
   launches counted in its process), the serving runs of phase 8, phase 10's
   serving and RTN packing, phase 13's two serving runs, phase 14's
   serving runs, phase 15's Engine runs and paligemma decode, and phase
   16's serving runs, causality probe, calibration serving and RTN
   packing for the seven serving-path kernels, phase 7 for the int8
   pair), never of the comparisons of phases 2, 8-16 or of phase 7's
   repack check (its quantize_pack calls are gated there, not counted).
   dequant_matmul's launches are also split by the body that ran
   (``launches_by_body`` in the kernels JSON line).
   Every phase logs its wall time.

Phases 3, 5, 6, 7, 9 and 17 share one packed llama-7b tree.
Every process the script starts is stopped when it ends, whether it
passes, fails or is sent SIGTERM; the script's own Python processes (mesh
ranks, side runs) also die with it if it is killed.
The last lines are one JSON object of the kernels (with phase 7's
``profiler_retries``), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
INT8_OPS_PER_S = 1979e12      # dense int8 tensor cores
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores

LAYERS = 32                   # llama-7b depth; cut here only if time forces
A16_LAYERS = 8
KERNELS = {"w4a8_matmul": "w4a8_matmul.cu",        # name -> source file
           "dequant_matmul": "dequant_matmul.cu",
           "flash_decode": "flash_decode.cu", "flash_prefill": "flash_prefill.cu",
           "flash_decode_paged": "flash_decode.cu",
           "flash_prefill_paged": "flash_prefill.cu",
           "int8_matmul": "int8_matmul.cu", "w8a8_matmul": "int8_matmul.cu",
           "quantize_pack": "quantize_pack.cu"}
# dequant_matmul's launches again, by the body of csrc/dequant_matmul.cu
# that ran (repro_torch.kernels._lib.LAUNCHES counts both)
DQ_BODIES = ("dequant_matmul/decode", "dequant_matmul/tile",
             "dequant_matmul/tile_split")
COUNTED = tuple(KERNELS) + DQ_BODIES


def zero_counts() -> dict:
    return {name: 0 for name in COUNTED}


# (M, K, N) of llama-7b's linears: decode (M 4) and a 512-token prefill
LINEAR_SHAPES = ((4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096),
                 (512, 4096, 11008))
# opt-125m's linears (q/k/v/o, fc1, fc2), decode and a 512-token prefill
OPT_LINEAR_SHAPES = tuple((m, k, n) for m in (4, 512)
                          for k, n in ((768, 768), (768, 3072), (3072, 768)))
# the MoE archs' attention linears: qwen3-moe-30b-a3b's q (2048 -> 4096),
# k / v (2048 -> 512) and o (4096 -> 2048), dbrx-132b's q / o (6144 ->
# 6144) and k / v (6144 -> 1024); decode and a 512-token prefill
MOE_LINEAR_SHAPES = tuple((m, k, n) for m in (4, 512)
                          for k, n in ((2048, 4096), (2048, 512),
                                       (4096, 2048), (6144, 6144),
                                       (6144, 1024)))
# the quantized vlm and audio archs' linears: hubert-xlarge's q/k/v/o (1280
# -> 1280), fc1 (1280 -> 5120) and fc2 (5120 -> 1280), paligemma-3b's q
# (2048 -> 2048), k / v (2048 -> 256), gate / up (2048 -> 16384) and down
# (16384 -> 2048); decode and a 512-token prefill
VLM_AUDIO_LINEAR_SHAPES = tuple((m, k, n) for m in (4, 512)
                                for k, n in ((1280, 1280), (1280, 5120),
                                             (5120, 1280), (2048, 2048),
                                             (2048, 256), (2048, 16384),
                                             (16384, 2048)))
# (D, G, Hkv) of hubert-xlarge's attention: D 80 is no multiple of 64 (the
# value-by-value copies) nor of 32, so phase 2 runs it at kv16 and kv8 only
# (kv4 is refused there, as in the reference); paligemma-3b's is gemma-2b's
AUDIO_ATTN = (80, 1, 16)
# (D, G, Hkv) of the dense registry's attention: phi4-mini, qwen2.5-14b,
# stablelm-12b, gemma-2b, and of the MoE registry's: qwen3-moe-30b-a3b,
# dbrx-132b; phase 2 runs each at kv16, kv8 and kv4
REGISTRY_ATTN = ((128, 3, 8), (128, 5, 8), (160, 4, 8), (256, 8, 1),
                 (128, 8, 4), (128, 6, 8))
# every ((D, G, Hkv), kv_bits) case phase 2 runs beside llama-7b's and
# opt-125m's, in each of the four attention kernels
ATTN_CASES = tuple((shape, kv_bits) for shape in REGISTRY_ATTN
                   for kv_bits in (16, 8, 4)) + tuple(
    (AUDIO_ATTN, kv_bits) for kv_bits in (16, 8))
# Earlier times of the redesigned kernels as PERF.md records them (H100
# 80GB HBM3, 700 W), logged beside this run's.
_MAIN_PREFILL = "B=4 C=128 S=128 Hkv=32 G=1 D=128 kv{} offset=[0, 0, 0, 0] chunk_len=[128, 128, 128, 128]"
_MAIN_PAGED = ("B=4 C=128 pages of 64, 8/seq, Hkv=32 G=1 D=128 kv{} "
               "offset=[0, 0, 0, 0] chunk_len=[128, 128, 128, 128]")
_MAIN_DECODE = "B=4 S=512 Hkv=32 G=1 D=128 kv{} cur_len=[144, 144, 144, 144]"
_MAIN_DECODE_PAGED = ("B=4 pages of 64, 8/seq, Hkv=32 G=1 D=128 kv{} "
                      "cur_len=[144, 144, 144, 144]")
EARLIER_MS = {
    "flash_decode " + _MAIN_DECODE.format(8): 0.0850,
    "flash_decode " + _MAIN_DECODE.format(4): 0.0864,
    "flash_decode_paged " + _MAIN_DECODE_PAGED.format(8): 0.0871,
    "flash_decode_paged " + _MAIN_DECODE_PAGED.format(4): 0.0904,
    "dequant_matmul M=4 K=4096 N=11008 w4 g128": 0.3616,
    # dequant_matmul's earlier tile body (64x64 tiles, 4x4 a thread,
    # synchronous slabs, no K cut), as PERF.md records it
    "dequant_matmul M=512 K=4096 N=11008 w4 g128": 1.8693,
    "dequant_matmul M=512 K=768 N=3072 w4 g128": 0.1057,
    "dequant_matmul M=512 K=2048 N=512 w4 g128": 0.1761,
    "dequant_matmul M=512 K=1280 N=1280 w4 g128": 0.1293,
    "dequant_matmul M=512 K=1280 N=5120 w4 g128": 0.2817,
    "dequant_matmul M=512 K=5120 N=1280 w4 g128": 0.4987,
    "dequant_matmul M=512 K=2048 N=2048 w4 g128": 0.2025,
    "dequant_matmul M=512 K=2048 N=256 w4 g128": 0.1770,
    "dequant_matmul M=512 K=2048 N=16384 w4 g128": 1.3505,
    "dequant_matmul M=512 K=16384 N=2048 w4 g128": 1.5613,
    "w4a8_matmul M=4 K=4096 N=4096 w4 g128 a4": 0.0803,
    "w4a8_matmul M=4 K=4096 N=11008 w4 g128 a4": 0.0829,
    "w4a8_matmul M=4 K=11008 N=4096 w4 g128 a4": 0.2104,
    "w4a8_matmul M=512 K=4096 N=11008 w4 g128 a4": 1.1112,
    "flash_prefill " + _MAIN_PREFILL.format(8): 0.1794,
    "flash_prefill " + _MAIN_PREFILL.format(4): 0.2205,
    "flash_prefill_paged " + _MAIN_PAGED.format(8): 0.1859,
    "flash_prefill_paged " + _MAIN_PAGED.format(4): 0.2639,
    # the earlier int8 bodies (mma.sync tile, split-K dp4a decode)
    "int8_matmul M=4 K=4096 N=4096": 0.0243,
    "int8_matmul M=4 K=4096 N=11008": 0.0445,
    "int8_matmul M=4 K=11008 N=4096": 0.0610,
    "int8_matmul M=512 K=4096 N=11008": 0.2078,
    "w8a8_matmul M=4 K=4096 N=4096": 0.0389,
    "w8a8_matmul M=4 K=4096 N=11008": 0.0520,
    "w8a8_matmul M=4 K=11008 N=4096": 0.0582,
    "w8a8_matmul M=512 K=4096 N=11008": 0.2173,
}
# quantize_pack's device work alone before its redesign (PERF.md; H100
# 80GB HBM3, 700 W), logged beside this run's
EARLIER_ALONE = {
    "K=4096 N=11008 w4 g128": 0.0963, "K=2048 N=4096 w4 g128": 0.0301,
    "K=2048 N=512 w4 g128": 0.0105, "K=4096 N=2048 w4 g128": 0.0299,
    "K=2048 N=768 w4 g128": 0.0117, "K=768 N=2048 w4 g128": 0.0116,
    "K=6144 N=10752 w4 g128": 0.1340, "K=10752 N=6144 w4 g128": 0.1333,
    "K=1280 N=1280 w4 g128": 0.0123, "K=1280 N=5120 w4 g128": 0.0257,
    "K=5120 N=1280 w4 g128": 0.0260, "K=2048 N=2048 w4 g128": 0.0202,
    "K=2048 N=256 w4 g128": 0.0093, "K=2048 N=16384 w4 g128": 0.0760,
    "K=16384 N=2048 w4 g128": 0.0754,
}


def log(msg: str) -> None:
    print(msg, flush=True)


# every process the script starts (mesh ranks, side runs, the training
# command); stop_children() kills what is left of them however main() ends
CHILDREN: list = []


def start_child(cmd: list, launcher: bool = False,
                **kw) -> subprocess.Popen:
    """``cmd`` started and registered.  A ``launcher`` (``torch.distributed
    .run``) is stopped with SIGTERM, which it forwards to its workers, and
    killed only if it has not ended 30 s later."""
    proc = subprocess.Popen(cmd, **kw)
    proc.launcher = launcher
    CHILDREN.append(proc)
    return proc


def stop_child(proc) -> None:
    if proc.poll() is None and proc.launcher:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def stop_children() -> None:
    for proc in CHILDREN:
        stop_child(proc)


def child_env() -> dict:
    """The environment of a process the script starts: the checkout's
    sources on the path, and this process's id for die_with_parent()."""
    import os
    return dict(os.environ, PYTHONPATH=str(SRC),
                CHIP_SMOKE_PARENT=str(os.getpid()))


def die_with_parent() -> None:
    """In a process the script started: be killed when the main process
    ends, even by SIGKILL (Linux's PR_SET_PDEATHSIG), and end now if it
    has already ended.  Nothing when run by hand (no CHIP_SMOKE_PARENT)."""
    import ctypes
    import os
    import signal
    parent = os.environ.get("CHIP_SMOKE_PARENT")
    if parent is None:
        return
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG
    if os.getppid() != int(parent):
        os._exit(1)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each.  With
    hide_host, a device sleep between the flush and the call keeps the card
    busy while the host enqueues the call, so the events time the call's
    device work alone.  With clean_l2, the flush buffer is also read back
    before the call, so the L2 holds no dirty lines for the call to write
    back.  ``host_ms``: the median host time of the last timing's calls
    (their enqueue: nothing in them synchronizes)."""

    HIDE_CYCLES = 300_000          # ~0.17 ms at the H100's 1.755 GHz

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.host_ms = None

    def __call__(self, fn, reps: int = 15, warm: int = 2,
                 hide_host: bool = False, clean_l2: bool = False) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs, host = [], []
        for _ in range(reps):
            self.flush.zero_()
            if clean_l2:
                self.flush.max()
            if hide_host:
                torch.cuda._sleep(self.HIDE_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        self.host_ms = statistics.median(host) * 1e3
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> None:
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's kernels "
                         "run only on the card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(src/repro_torch not found)")
    sys.path.insert(0, str(SRC))
    # float32 matmuls left to PyTorch (vocab head, activation transforms,
    # the plain versions) stay full float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    results = {}

    # ---- 1. build ----------------------------------------------------------
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.lib()
    log(f"[build] {len(_lib.SOURCES)} sources -> {_lib.BUILD_INFO['path']} "
        f"in {time.perf_counter() - t0:.1f} s (cached={_lib.BUILD_INFO['cached']})")
    log_path = _lib.BUILD_INFO.get("log")
    if log_path and Path(log_path).exists():
        for line in Path(log_path).read_text().splitlines():
            if "registers" in line or "spill stores" in line:
                log("[build]   " + line.strip())

    check_wgmma_sass(_lib)

    timer = Timer(torch)
    check_kernels(torch, timer, results)
    check_paged_kernels(torch, timer, results)
    check_int8_kernels(torch, timer, results)
    check_quantize_pack(torch, timer, results)
    check_griffin_attention(torch, timer, results)
    check_slices(torch)
    del timer
    torch.cuda.empty_cache()

    # ---- 3-6. serving; one packed llama-7b tree shared by 3, 5 and 6 ------
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    _lib.reset_launches()
    params = serve.build_model(serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(LAYERS)]))[2]
    torch.cuda.synchronize()
    startup = dict(_lib.LAUNCHES)
    log(f"[serve] random init + RTN packing of the llama-7b tree "
        f"{time.perf_counter() - t0:.1f} s; launches {startup}")
    if startup["quantize_pack"] != 7 * LAYERS:
        raise RuntimeError(f"startup: {startup['quantize_pack']} quantize_pack "
                           f"launches packed the served tree, not one per "
                           f"linear ({7 * LAYERS})")
    counts, streams, prompts = serve_w4a4(torch, params)
    phases = [startup, serve_a16(torch), serve_paged(torch, params, streams),
              serve_kv4(torch, params)]
    # ---- 9. the Engine contract, on the same tree -------------------------
    phases.append(engine_contract(torch, params, list(prompts.numpy()),
                                  streams))
    # ---- 17. mesh-native serving, on the same tree ------------------------
    phases.append(mesh_phase(torch, params, streams))
    # phase 7 traces its calls under torch.profiler before any other
    # process shares the card
    repacked, retries = repack(torch, params, prompts)
    # phase 7's quantize_pack calls are its repack comparison, not a run of
    # the main path; only its int8 pair counts
    repacked["quantize_pack"] = 0
    phases.append(repacked)
    del params
    torch.cuda.empty_cache()
    # (d)-(e): their ranks run beside phase 11
    families = MeshFamilies(torch, card_name(torch))

    # ---- 11. the float llama-7b beside phase 3's W4A4 tree ----------------
    phases.append(float_llama_phase(torch, streams))
    phases.append(families.finish(torch))

    # ---- 8. calibrate llama-7b-width blocks and serve what they pack -------
    ppl = {}
    phases.append(calibrate_phase(torch, ppl))

    # ---- 10. opt-125m: AffineQuant, serving, the RTN / AWQ / GPTQ baselines -
    phases.append(opt_phase(torch, ppl))

    # ---- 12. the dense registry at published widths, and W3A16 -----------
    phases.append(registry_phase(torch))

    # ---- 13. training, and the paper's methods on trained miniatures -------
    phases.append(train_phase(torch))

    # ---- 14. the MoE family ------------------------------------------------
    phases.append(moe_phase(torch))

    # ---- 15. the recurrent families, the vlm and audio float paths --------
    phases.append(recurrent_phase(torch))

    # ---- 16. quantized vlm and audio ---------------------------------------
    phases.append(vlm_audio_phase(torch))

    # ---- 18. training on a mesh --------------------------------------------
    phases.append(mesh_train_phase(torch))

    # ---- 19. summary -------------------------------------------------------
    for phase in phases:
        for name, n in phase.items():
            counts[name] += n
    bodies = {name.split("/")[1]: counts[name] for name in DQ_BODIES}
    log(f"[summary] dequant_matmul launches on the main path by body: "
        f"{bodies} (decode M <= 8; tile and tile with K cut across blocks "
        f"M > 8)")
    if sum(bodies.values()) != counts["dequant_matmul"]:
        raise RuntimeError(f"dequant_matmul's launches by body {bodies} do "
                           f"not add up to {counts['dequant_matmul']}")
    kernels = []
    for name in KERNELS:
        r = results[name]
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was never launched on the main path")
        kernels.append({"name": name, "route": "cuda",
                         "source": f"src/repro_torch/csrc/{KERNELS[name]}",
                         "replaces": r["replaces"], "launches": counts[name],
                         "max_abs_err": r["max_abs_err"], "tol": r["tol"],
                         "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"], "shape": r["shape"],
                         # aliases of the numbers above
                         "tpu": r["replaces"], "max_err": r["max_abs_err"],
                         "kernel_ms": r["ms"],
                         "bound_us": r["bound_ms"] * 1e3})
        if name == "dequant_matmul":
            kernels[-1]["launches_by_body"] = bodies
    log(f"[total] {time.perf_counter() - t_start:.1f} s; phase 7 traced "
        f"{retries} call(s) again after the profiler lost their device "
        f"records")
    print(json.dumps({"kernels": kernels, "profiler_retries": retries}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_wgmma_sass(_lib) -> None:
    """The int8 tile body must be compiled to Hopper's asynchronous pipeline:
    its SASS (cuobjdump, beside nvcc) holds TMA loads (UTMALDG), mbarrier
    waits (SYNCS) and warpgroup MMAs (IGMMA or HGMMA)."""
    cuobjdump = Path(_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", _lib.BUILD_INFO["path"]],
                          capture_output=True, text=True, check=True).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if "int8_wgmma_kernel" in part.splitlines()[0]), None)
    if body is None:
        raise RuntimeError("chip_smoke: int8_wgmma_kernel not in the library")
    counts = {op: body.count(op) for op in ("UTMALDG", "SYNCS", "GMMA")}
    log(f"[build] int8_wgmma_kernel SASS: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"int8_wgmma_kernel lacks TMA / mbarrier / wgmma "
                           f"instructions: {counts}")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions at the serving shapes
# ---------------------------------------------------------------------------

def _record(results, name, case, err, tol, ms, plain_ms, lib_ms, bms, by,
            replaces, main_case):
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    earlier = EARLIER_MS.get(f"{name} {case}")
    earlier = "" if earlier is None else f" (PERF.md, earlier body: {earlier:.4f} ms)"
    log(f"[kernel] {name} {case}: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"kernel {ms:.4f} ms{earlier}, plain {plain_ms:.4f} ms, library {lib}, "
        f"bound {bms:.4g} ms ({by})")
    if not err <= tol:
        raise RuntimeError(f"{name} {case}: error {err} above tolerance {tol}")
    if main_case:
        results[name] = {"replaces": replaces, "max_abs_err": err, "tol": tol,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "shape": case}


def kv_cache_tensors(torch, gen, lead, hkv, d, kv_bits):
    """(k, v, k_scale, v_scale) cache rows ``lead`` on the card in format
    ``kv_bits``: float32; random int8 codes with float32 scales; or random
    nibble bytes with bf16 scales."""
    dev = "cuda"
    if kv_bits == 16:
        return tuple(torch.randn(lead + (hkv, d), generator=gen, device=dev)
                     for _ in range(2)) + (None, None)
    dk = d // 2 if kv_bits == 4 else d
    codes = lambda: torch.randint(-128, 128, lead + (hkv, dk), generator=gen,
                                  device=dev, dtype=torch.int8)
    if kv_bits == 8:
        sc = lambda: torch.rand(lead + (hkv,), generator=gen, device=dev) * 0.05 + 0.01
    else:
        sc = lambda: (torch.rand(lead + (hkv, d // 32), generator=gen, device=dev)
                      * 0.05 + 0.01).to(torch.bfloat16)
    return (codes(), codes(), sc(), sc())


def dequant(kv):
    """Float32 K and V of a cache tuple (the library yardstick's input)."""
    from repro_torch.kernels.flash_decode import dequant_tile
    return dequant_tile(kv[0], kv[2]), dequant_tile(kv[1], kv[3])


def kv_token_bytes(kv_bits: int, hkv: int, d: int) -> int:
    """Cache bytes of one position, K and V: 2 * (4 D) at kv16,
    2 * (D + 4) at kv8, 2 * (D / 2 + 2 D / 32) at kv4, per KV head."""
    per = {16: 4 * d, 8: d + 4, 4: d // 2 + 2 * (d // 32)}[kv_bits]
    return 2 * hkv * per


def check_kernels(torch, timer, results) -> None:
    import torch.nn.functional as F
    from repro_torch.core.packing import pack
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import int8_matmul as i8
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # ---- the two matmuls: every linear shape of llama-7b, decode + prefill
    g, bits = 128, 4
    for m, k, n in (LINEAR_SHAPES + OPT_LINEAR_SHAPES + MOE_LINEAR_SHAPES
                    + VLM_AUDIO_LINEAR_SHAPES):
        x = randn(m, k)
        codes = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                              dtype=torch.uint8)
        packed = pack(codes, bits)
        scale = torch.rand((k // g, n), generator=gen, device=dev) * 0.01 + 1e-3
        zp = torch.randint(0, 16, (k // g, n), generator=gen, device=dev
                           ).to(torch.float32)
        w = ((codes.to(torch.float32).reshape(k // g, g, n) - zp[:, None])
             * scale[:, None]).reshape(k, n)
        nbytes = (packed.numel() + 8 * scale.numel() + 4 * m * k + 4 * m * n)
        case = f"M={m} K={k} N={n} w4 g128"
        main = (m, k, n) == (4, 4096, 11008)
        lib_ms = timer(lambda: torch.matmul(x, w))

        want = i8.quant_matmul_plain(x, packed, scale, zp, bits=bits,
                                     group_size=g, a_bits=4)
        got = i8.w4a8_matmul(x, packed, scale, zp, bits=bits, group_size=g,
                             a_bits=4)
        _require_equal(torch, "w4a8_matmul", case + " a4", got, want)
        if m > 4:
            # rows do not depend on M: decode body (M = 4) vs tile body
            if not torch.equal(i8.w4a8_matmul(x[:4], packed, scale, zp,
                                              bits=bits, group_size=g,
                                              a_bits=4), got[:4]):
                raise RuntimeError(f"w4a8_matmul {k}->{n}: rows at M=4 "
                                   f"differ from the same rows at M={m}")
            log(f"[kernel] w4a8_matmul {k}->{n}: rows at M=4 equal the "
                f"first 4 rows at M={m} (bit-equal)")
        bms, by = bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
        def call():
            i8.w4a8_matmul(x, packed, scale, zp, bits=bits, group_size=g,
                           a_bits=4)
        dev_ms = timer(call, hide_host=True)
        ms = timer(call)
        host_ms = timer.host_ms
        _record(results, "w4a8_matmul", case + " a4", 0.0, 0.0, ms,
                timer(lambda: i8.quant_matmul_plain(
                    x, packed, scale, zp, bits=bits, group_size=g, a_bits=4),
                    reps=5),
                lib_ms, bms, by, "src/repro/kernels/int8_matmul.py:188", main)
        log(f"[kernel] w4a8_matmul {case} a4: {ms / lib_ms:.3f}x the time of "
            f"torch.matmul ({'faster' if ms < lib_ms else 'SLOWER'}); "
            f"device work alone {dev_ms:.4f} ms, host enqueue "
            f"{host_ms:.4f} ms a call")

        if ((m, k, n) not in LINEAR_SHAPES + VLM_AUDIO_LINEAR_SHAPES
                and (k, n) not in ((768, 3072), (2048, 512))):
            continue          # dequant_matmul: opt-125m's fc1, qwen3-moe's k

        want = dq.dequant_matmul_plain(x, packed, scale, zp, bits=bits,
                                       group_size=g)
        got = dq.dequant_matmul(x, packed, scale, zp, bits=bits, group_size=g)
        body = dq.plan(m, k, n)
        if m > 4:
            # rows do not depend on M or on the body: decode (M = 4), and
            # tile bodies at 64 rows and at M
            for rows in (4, 64):
                if not torch.equal(dq.dequant_matmul(x[:rows], packed, scale,
                                                     zp, bits=bits,
                                                     group_size=g),
                                   got[:rows]):
                    raise RuntimeError(f"dequant_matmul {k}->{n}: rows at "
                                       f"M={rows} differ from the same rows "
                                       f"at M={m}")
            log(f"[kernel] dequant_matmul {k}->{n}: rows at M=4 "
                f"({dq.plan(4, k, n)['body']}) and M=64 "
                f"({dq.plan(64, k, n)['body']}) equal the first rows at M={m} "
                f"({body}) (bit-equal)")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        bms, by = bound(nbytes, 2 * m * k * n, FP32_OPS_PER_S)
        ms = timer(lambda: dq.dequant_matmul(x, packed, scale, zp, bits=bits,
                                             group_size=g))
        _record(results, "dequant_matmul", case, err, tol, ms,
                timer(lambda: dq.dequant_matmul_plain(
                    x, packed, scale, zp, bits=bits, group_size=g), reps=5),
                lib_ms, bms, by, "src/repro/kernels/dequant_matmul.py:80",
                main)
        shape = ("" if body["body"] == "decode" else
                 f" {body['bm']}x{body['bn']} in {body['chunks']} K chunk(s)")
        log(f"[kernel] dequant_matmul {case}: {body['body']} body{shape}; "
            f"{ms / lib_ms:.3f}x the time of torch.matmul "
            f"({'faster' if ms <= lib_ms else 'SLOWER'}), {bms / ms:.1%} of "
            f"the bound")
        del x, codes, packed, scale, zp, w, want, got

    # ---- attention over the llama-7b cache: B 4, S 512, D 128, and one
    # long context (S 2048, a 67 MB kv8 cache)
    b, s, d = 4, 512, 128

    def cache(hkv, kv_bits, s=s, hd=d):
        return kv_cache_tensors(torch, gen, (b, s), hkv, hd, kv_bits)

    # llama-7b (D 128), opt-125m (Hkv 12, D 64) and a D-32 kv4 case (the
    # value-by-value copy path of csrc/flash_decode.cu)
    for hkv, gq, kv_bits, lens, s, hd in (
            (32, 1, 8, (144, 144, 144, 144), 512, d),
            (32, 1, 8, (0, 1, 257, 512), 512, d),
            (32, 1, 16, (144, 144, 144, 144), 512, d),
            (32, 1, 4, (144, 144, 144, 144), 512, d),
            (8, 4, 8, (0, 31, 300, 512), 512, d),
            (32, 1, 8, (2048,) * 4, 2048, d),
            (12, 1, 8, (144, 144, 144, 144), 512, 64),
            (12, 1, 4, (144, 144, 144, 144), 512, 64),
            (8, 1, 4, (144, 144, 144, 144), 512, 32)) + tuple(
            (hkv, gq, kv_bits, (144,) * 4, 512, hd)
            for (hd, gq, hkv), kv_bits in ATTN_CASES):
        kv = cache(hkv, kv_bits, s, hd)
        q = randn(b, hkv, gq, hd)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, kv[0], kv[1], cur, kv[2], kv[3],
                                     block_kv=512)
        got = fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if any(x == 0 for x in lens) and got[cur == 0].any():
            raise RuntimeError("flash_decode: a cur_len == 0 row is not zero")
        # never a float copy of the cache: peak allocation below one fp32 K
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fp32_copy = b * s * hkv * hd * 4
        log(f"[kernel] flash_decode peak extra memory {peak} B < one fp32 "
            f"cache copy {fp32_copy} B")
        if peak >= fp32_copy:
            raise RuntimeError("flash_decode materialised the cache")
        kf, vf = dequant(kv)
        kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
        qt = q.reshape(b, hkv * gq, 1, hd)
        mask = (torch.arange(s, device=dev)[None, :] < cur[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        total = int(sum(lens))
        nbytes = total * kv_token_bytes(kv_bits, hkv, hd) + 2 * q.numel() * 4 + 4 * b
        bms, by = bound(nbytes, 4 * hd * gq * hkv * total, FP32_OPS_PER_S)
        case = (f"B={b} S={s} Hkv={hkv} G={gq} D={hd} "
                f"kv{kv_bits} cur_len={list(lens)}")
        main = kv_bits == 8 and gq == 1 and lens[0] == 144 and hd == d
        _record(results, "flash_decode", case, err, tol,
                timer(lambda: fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])),
                timer(lambda: fd.flash_decode_plain(
                    q, kv[0], kv[1], cur, kv[2], kv[3], block_kv=512), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_decode.py:129", main)

    del kv, q, kf, vf, kt, vt
    c = 128
    for hkv, gq, kv_bits, offs, cls, sc, hd in (
            (32, 1, 8, (0, 0, 0, 0), (128, 128, 128, 128), 128, d),
            (32, 1, 8, (0, 5, 300, 0), (128, 0, 77, 3), 512, d),
            (32, 1, 16, (0, 0, 0, 0), (128, 128, 128, 128), 128, d),
            (32, 1, 4, (0, 0, 0, 0), (128, 128, 128, 128), 128, d),
            (8, 4, 8, (0, 40, 384, 0), (128, 100, 128, 0), 512, d),
            (12, 1, 8, (16, 16, 16, 16), (128, 128, 128, 128), 144, 64),
            (12, 1, 4, (16, 16, 16, 16), (128, 128, 128, 128), 144, 64)
    ) + tuple((hkv, gq, kv_bits, (16,) * 4, (128,) * 4, 144, hd)
              for (hd, gq, hkv), kv_bits in ATTN_CASES):
        kv = cache(hkv, kv_bits, hd=hd)
        kv = tuple(None if t is None else t[:, :sc].contiguous() for t in kv)
        q = randn(b, hkv, c, gq, hd)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cl = torch.tensor(cls, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_plain(q, kv[0], kv[1], off, cl, kv[2], kv[3],
                                      block_kv=min(512, sc))
        got = fp.flash_prefill(q, kv[0], kv[1], off, cl, kv[2], kv[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        kf, vf = dequant(kv)
        kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
        qt = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * gq, c, hd)
        rows = torch.arange(c, device=dev)
        mask = ((torch.arange(sc, device=dev)[None, None, :]
                 <= off[:, None, None] + rows[None, :, None])
                & (rows[None, :, None] < cl[:, None, None]))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        attended = sum(min(o + x + 1, sc) for o, n in zip(offs, cls)
                       for x in range(n))
        prefix = sum(min(o + n, sc) for o, n in zip(offs, cls) if n)
        nbytes = prefix * kv_token_bytes(kv_bits, hkv, hd) + 2 * q.numel() * 4 + 8 * b
        bms, by = bound(nbytes, 4 * hd * gq * hkv * attended, FP32_OPS_PER_S)
        case = (f"B={b} C={c} S={sc} Hkv={hkv} G={gq} D={hd} "
                f"kv{kv_bits} offset={list(offs)} chunk_len={list(cls)}")
        main = kv_bits == 8 and gq == 1 and cls[1] == 128 and hd == d
        _record(results, "flash_prefill", case, err, tol,
                timer(lambda: fp.flash_prefill(q, kv[0], kv[1], off, cl,
                                               kv[2], kv[3])),
                timer(lambda: fp.flash_prefill_plain(
                    q, kv[0], kv[1], off, cl, kv[2], kv[3],
                    block_kv=min(512, sc)), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_prefill.py:143",
                main)

    # the resume contract on the card: a one-token chunk is decode
    kv = cache(32, 8)
    q = randn(b, 1, 32, d)
    cur = torch.tensor([1, 100, 257, 512], dtype=torch.int32, device=dev)
    from repro_torch.kernels import ops
    if not torch.equal(ops.flash_decode(q, kv, cur),
                       ops.flash_prefill(q, kv, cur - 1, torch.ones_like(cur))):
        raise RuntimeError("a one-token flash_prefill chunk differs from "
                           "flash_decode")
    log("[kernel] one-token flash_prefill == flash_decode (bit-equal)")
    check_chunk_split(torch, "flash_prefill", gen, lambda kv, o, n, qq:
                      fp.flash_prefill(qq, kv[0], kv[1], o, n, kv[2], kv[3]),
                      lambda kv_bits: cache(32, kv_bits))


# the column slices a (1, m) mesh gives each rank of llama-7b's
# column-parallel linears: q/k/v (4096 -> 4096) and gate / up (4096 ->
# 11008: 5504 and 2752 columns are ragged N); wo / w_down stay whole
SLICE_LINEARS = ((4096, 4096), (4096, 11008))
SLICE_PARTS = (2, 4)
# (D, G, Hkv) of the attention head slices: llama-7b (MHA) and
# qwen2.5-14b (GQA: 8 KV heads become 4 and 2, where flash_decode tiles
# its G rows differently)
SLICE_ATTN = ((128, 1, 32), (128, 5, 8))


def check_slices(torch) -> None:
    """Phase 2, slice identity: each rank of a (1, m) mesh runs a kernel on
    its slice, so a slice's result must be the same bits as the same part
    of the whole call.  w4a8_matmul (w4 g128 a4) and dequant_matmul (w4
    g128) at M 4 and 512 on contiguous column slices of the packed weight
    (codes, scales and zero points cut alike) against the same columns of
    the full product; the four attention kernels (kv8 and kv4, both
    layouts) on contiguous head slices of q and of the cache against the
    same heads of the full call.  Equality only, m = 2 and 4."""
    from repro_torch.core.packing import pack
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(27)
    dev = "cuda"

    def equal(name, case, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"[slice] {name} {case}: a slice differs "
                               f"from the same part of the full call")

    g = 128
    for k, n in SLICE_LINEARS:
        codes = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                              dtype=torch.uint8)
        qt = QTensor(pack(codes, 4),
                     torch.rand((k // g, n), generator=gen, device=dev)
                     * 0.01 + 1e-3,
                     torch.randint(0, 16, (k // g, n), generator=gen,
                                   device=dev).to(torch.float32), 4, g)
        for m in (4, 512):
            x = torch.randn((m, k), generator=gen, device=dev)
            calls = {"w4a8_matmul": lambda w: ops.quant_matmul(x, w,
                                                               a_bits=4),
                     "dequant_matmul": lambda w: ops.dequant_matmul(x, w)}
            for name, call in calls.items():
                whole = call(qt)
                for parts in SLICE_PARTS:
                    step = n // parts
                    for r in range(parts):
                        cols = slice(r * step, (r + 1) * step)
                        part = QTensor(*(t[:, cols].contiguous() for t in (
                            qt.packed, qt.scale, qt.zp)), 4, g)
                        equal(name, f"M={m} K={k} N={n} / {parts}",
                              call(part), whole[:, cols])
            bodies = {p: dq.plan(m, k, n // p)["body"] for p in
                      (1,) + SLICE_PARTS}
            log(f"[slice] w4a8_matmul and dequant_matmul M={m} {k}->{n}: "
                f"column slices of N/2 and N/4 ({n // 2}, {n // 4} columns) "
                f"equal the same columns of the full product (bit-equal; "
                f"dequant_matmul bodies {bodies})")
    lens = [144, 1, 300, 512]
    b, s, ps = len(lens), 512, 64
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    off = torch.tensor([0, 64, 300, 17], dtype=torch.int32, device=dev)
    cl = torch.tensor([128, 100, 0, 1], dtype=torch.int32, device=dev)
    for d, grp, hkv in SLICE_ATTN:
        hq = hkv * grp
        for kv_bits in (8, 4):
            pools, pt, lin = paged_case(torch, gen, [s] * b, hkv, d, ps,
                                        kv_bits, s // ps)
            qd = torch.randn((b, 1, hq, d), generator=gen, device=dev)
            qp = torch.randn((b, 128, hq, d), generator=gen, device=dev)
            calls = {
                "flash_decode": lambda q, kv: ops.flash_decode(q, kv, cur),
                "flash_decode_paged": lambda q, kv: ops.flash_decode(
                    q, kv, cur, page_table=pt),
                "flash_prefill": lambda q, kv: ops.flash_prefill(
                    q, kv, off, cl),
                "flash_prefill_paged": lambda q, kv: ops.flash_prefill(
                    q, kv, off, cl, page_table=pt)}
            for name, call in calls.items():
                kv = pools if name.endswith("paged") else lin
                q = qd if "decode" in name else qp
                whole = call(q, kv)
                for parts in SLICE_PARTS:
                    hs, qs = hkv // parts, hq // parts
                    for r in range(parts):
                        heads = slice(r * hs, (r + 1) * hs)
                        part_kv = tuple(t[:, :, heads].contiguous()
                                        for t in kv)
                        got = call(q[:, :, r * qs:(r + 1) * qs].contiguous(),
                                   part_kv)
                        equal(name, f"kv{kv_bits} D={d} G={grp} Hkv={hkv} "
                              f"/ {parts}", got,
                              whole[:, :, r * qs:(r + 1) * qs])
            log(f"[slice] the four attention kernels kv{kv_bits} D={d} "
                f"G={grp} Hkv={hkv}: head slices of Hkv/2 and Hkv/4 equal "
                f"the same heads of the full call (bit-equal, both layouts)")


# recurrentgemma-2b's local attention: MQA with 10 query heads of 256
GRIFFIN_ATTN = (256, 10, 1)               # (D, G, Hkv)


def check_griffin_attention(torch, timer, results) -> None:
    """flash_decode and flash_prefill at recurrentgemma's shape (Hkv 1, G
    10, D 256, kv16), each against its plain version: decode at B 4 over a
    512-position cache, over the wrapped 2,048-slot ring (every slot
    valid), and at B 48 over the ring with ragged lengths (B 48 is where
    the kernel's row tiles become 4 + 4 + 2); prefill of a 128-token chunk
    at B 4 and of the Engine's whole 2,040-token prompt at B 1."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device="cuda").manual_seed(15)
    dev = "cuda"
    hd, gq, hkv = GRIFFIN_ATTN
    for b, s, lens in ((4, 512, (144,) * 4), (4, 2048, (2048,) * 4),
                       (48, 2048, (2048, 1000, 144, 1) * 12)):
        kv = kv_cache_tensors(torch, gen, (b, s), hkv, hd, 16)
        q = torch.randn((b, hkv, gq, hd), generator=gen, device=dev)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, kv[0], kv[1], cur, block_kv=512)
        got = fd.flash_decode(q, kv[0], kv[1], cur)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        kt, vt = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
        qt = q.reshape(b, hkv * gq, 1, hd)
        mask = (torch.arange(s, device=dev)[None, :]
                < cur[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        total = int(sum(lens))
        nbytes = total * kv_token_bytes(16, hkv, hd) + 2 * q.numel() * 4 + 4 * b
        bms, by = bound(nbytes, 4 * hd * gq * hkv * total, FP32_OPS_PER_S)
        ring = " (the wrapped ring)" if s == 2048 else ""
        case = (f"B={b} S={s}{ring} Hkv={hkv} G={gq} D={hd} kv16 "
                f"cur_len={list(lens[:4])}{'...' if b > 4 else ''}")
        _record(results, "flash_decode", case, err, tol,
                timer(lambda: fd.flash_decode(q, kv[0], kv[1], cur)),
                timer(lambda: fd.flash_decode_plain(q, kv[0], kv[1], cur,
                                                    block_kv=512), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_decode.py:129",
                False)
        del kv, q, kt, vt
    for b, c in ((4, 128), (1, 2040)):
        k, v = (torch.randn((b, c, hkv, hd), generator=gen, device=dev)
                for _ in range(2))
        q = torch.randn((b, hkv, c, gq, hd), generator=gen, device=dev)
        off = torch.zeros((b,), dtype=torch.int32, device=dev)
        cl = off + c
        want = fp.flash_prefill_plain(q, k, v, off, cl, block_kv=c)
        got = fp.flash_prefill(q, k, v, off, cl)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        qt = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * gq, c, hd)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        attended = b * c * (c + 1) // 2
        nbytes = b * c * kv_token_bytes(16, hkv, hd) + 2 * q.numel() * 4 + 8 * b
        bms, by = bound(nbytes, 4 * hd * gq * hkv * attended, FP32_OPS_PER_S)
        case = (f"B={b} C={c} S={c} Hkv={hkv} G={gq} D={hd} kv16 "
                f"offset=[0] chunk_len=[{c}]")
        _record(results, "flash_prefill", case, err, tol,
                timer(lambda: fp.flash_prefill(q, k, v, off, cl)),
                timer(lambda: fp.flash_prefill_plain(q, k, v, off, cl,
                                                     block_kv=c), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_prefill.py:143",
                False)
        del k, v, q, kt, vt


def check_chunk_split(torch, name, gen, call, make_cache) -> None:
    """Raise unless a chunk split in two equals the whole chunk bit for bit
    (llama-7b: B 4, Hkv 32, G 1, D 128, C 128, ragged offsets and lengths
    including 0; splits after 37 and 64 tokens), kv16/kv8/kv4."""
    dev = "cuda"
    off = torch.tensor([0, 64, 300, 17], dtype=torch.int32, device=dev)
    cl = torch.tensor([128, 100, 0, 1], dtype=torch.int32, device=dev)
    for kv_bits in (16, 8, 4):
        kv = make_cache(kv_bits)
        q = torch.randn((4, 32, 128, 1, 128), generator=gen, device=dev)
        whole = call(kv, off, cl, q)
        for c1 in (37, 64):
            first = call(kv, off, torch.clamp(cl, max=c1),
                         q[:, :, :c1].contiguous())
            second = call(kv, off + c1, torch.clamp(cl - c1, min=0),
                          q[:, :, c1:].contiguous())
            if not torch.equal(torch.cat([first, second], 2), whole):
                raise RuntimeError(f"{name} kv{kv_bits}: two chunks split "
                                   f"after {c1} tokens differ from the whole")
    log(f"[kernel] {name}: two chunks == the whole chunk (bit-equal, "
        f"kv16/kv8/kv4, splits after 37 and 64 tokens)")


def paged_case(torch, gen, lens, hkv, d, ps, kv_bits, max_pages):
    """Pools for ``max_pages`` pages per sequence, a shuffled page table
    holding ceil(len / ps) pages per row and -1 past them, and the linear
    cache the table spells out (same contents, -1 reading page 0)."""
    b = len(lens)
    num_pages = b * max_pages
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(
        ps + kv_bits + hkv))
    pt = torch.full((b, max_pages), -1, dtype=torch.int32)
    used = 0
    for row, n in enumerate(lens):
        k = -(-n // ps)
        pt[row, :k] = perm[used:used + k].to(torch.int32)
        used += k
    pt = pt.cuda()
    pools = kv_cache_tensors(torch, gen, (num_pages, ps), hkv, d, kv_bits)
    idx = pt.long().clamp_min(0)
    lin = tuple(None if e is None else
                e[idx].reshape(b, -1, *e.shape[2:]).contiguous()
                for e in pools)
    return pools, pt, lin


def check_paged_kernels(torch, timer, results) -> None:
    """The paged kernels at llama-7b shapes (B 4, Hkv 32, G 1, D 128, pages
    of 64, a pool of 8 pages per sequence for max_len 512, a shuffled page
    table with -1 tails), each against its plain version and bit for bit
    against its linear kernel on the same contents."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    b, d, max_len = 4, 128, 512

    def sdpa_kv(lin):
        return tuple(t.transpose(1, 2) for t in dequant(lin))

    for hkv, gq, kv_bits, ps, lens, max_len, hd in (
            (32, 1, 8, 64, (144, 144, 144, 144), 512, d),
            (32, 1, 16, 64, (144, 144, 144, 144), 512, d),
            (32, 1, 4, 64, (144, 144, 144, 144), 512, d),
            (32, 1, 8, 64, (0, 1, 257, 512), 512, d),
            (8, 4, 8, 64, (0, 31, 300, 512), 512, d),
            (32, 1, 8, 16, (0, 17, 144, 512), 512, d),
            (32, 1, 4, 16, (0, 17, 144, 512), 512, d),
            (32, 1, 8, 64, (2048,) * 4, 2048, d),
            (12, 1, 8, 64, (144, 144, 144, 144), 512, 64),
            (12, 1, 4, 64, (144, 144, 144, 144), 512, 64),
            (8, 1, 4, 64, (144, 144, 144, 144), 512, 32)) + tuple(
            (hkv, gq, kv_bits, 64, (144,) * 4, 512, hd)
            for (hd, gq, hkv), kv_bits in ATTN_CASES):
        max_pages = max_len // ps
        pools, pt, lin = paged_case(torch, gen, lens, hkv, hd, ps, kv_bits,
                                    max_pages)
        q = torch.randn((b, hkv, gq, hd), generator=gen, device=dev)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = fd.flash_decode_paged_plain(q, pools[0], pools[1], pt, cur,
                                           *pools[2:])
        got = fd.flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if not torch.equal(got, fd.flash_decode(q, lin[0], lin[1], cur,
                                                *lin[2:])):
            raise RuntimeError(f"flash_decode_paged kv{kv_bits} page {ps}: "
                               f"differs from flash_decode on the same "
                               f"contents")
        if got[cur == 0].any():
            raise RuntimeError("flash_decode_paged: a cur_len == 0 row is "
                               "not zero")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fd.flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fp32_copy = b * max_len * hkv * hd * 4
        if peak >= fp32_copy:
            raise RuntimeError("flash_decode_paged materialised the cache")
        kt, vt = sdpa_kv(lin)
        qt = q.reshape(b, hkv * gq, 1, hd)
        mask = (torch.arange(kt.shape[2], device=dev)[None, :]
                < cur[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        total = int(sum(lens))
        pages_read = sum(-(-n // ps) for n in lens)
        nbytes = (total * kv_token_bytes(kv_bits, hkv, hd) + 4 * pages_read
                  + 2 * q.numel() * 4 + 4 * b)
        bms, by = bound(nbytes, 4 * hd * gq * hkv * total, FP32_OPS_PER_S)
        case = (f"B={b} pages of {ps}, {max_pages}/seq, Hkv={hkv} G={gq} "
                f"D={hd} kv{kv_bits} cur_len={list(lens)}")
        log(f"[kernel] flash_decode_paged {case}: equals flash_decode bit "
            f"for bit; peak extra memory {peak} B < {fp32_copy} B")
        main = (kv_bits == 8 and gq == 1 and ps == 64 and lens[0] == 144
                and hd == d)
        _record(results, "flash_decode_paged", case, err, tol,
                timer(lambda: fd.flash_decode_paged(q, pools[0], pools[1], pt,
                                                    cur, *pools[2:])),
                timer(lambda: fd.flash_decode_paged_plain(
                    q, pools[0], pools[1], pt, cur, *pools[2:]), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_decode.py:216",
                main)

    del pools, lin, q, kt, vt
    max_len = 512
    c = 128
    for hkv, gq, kv_bits, ps, offs, cls, hd in (
            (32, 1, 8, 64, (0, 0, 0, 0), (128, 128, 128, 128), d),
            (32, 1, 16, 64, (0, 0, 0, 0), (128, 128, 128, 128), d),
            (32, 1, 4, 64, (0, 0, 0, 0), (128, 128, 128, 128), d),
            (32, 1, 8, 64, (0, 5, 300, 0), (128, 0, 77, 3), d),
            (8, 4, 8, 64, (0, 40, 384, 0), (128, 100, 128, 0), d),
            (32, 1, 8, 16, (0, 21, 384, 64), (128, 1, 128, 0), d),
            (32, 1, 4, 16, (0, 21, 384, 64), (128, 1, 128, 0), d),
            (12, 1, 8, 64, (16, 16, 16, 16), (128, 128, 128, 128), 64),
            (12, 1, 4, 64, (16, 16, 16, 16), (128, 128, 128, 128), 64)
    ) + tuple((hkv, gq, kv_bits, 64, (16,) * 4, (128,) * 4, hd)
              for (hd, gq, hkv), kv_bits in ATTN_CASES):
        max_pages = max_len // ps
        ends = [o + n for o, n in zip(offs, cls)]
        pools, pt, lin = paged_case(torch, gen, ends, hkv, hd, ps, kv_bits,
                                    max_pages)
        q = torch.randn((b, hkv, c, gq, hd), generator=gen, device=dev)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cl = torch.tensor(cls, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_paged_plain(q, pools[0], pools[1], pt, off,
                                            cl, *pools[2:])
        got = fp.flash_prefill_paged(q, pools[0], pools[1], pt, off, cl,
                                     *pools[2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if not torch.equal(got, fp.flash_prefill(q, lin[0], lin[1], off, cl,
                                                 *lin[2:])):
            raise RuntimeError(f"flash_prefill_paged kv{kv_bits} page {ps}: "
                               f"differs from flash_prefill on the same "
                               f"contents")
        kt, vt = sdpa_kv(lin)
        qt = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * gq, c, hd)
        rows = torch.arange(c, device=dev)
        mask = ((torch.arange(kt.shape[2], device=dev)[None, None, :]
                 <= off[:, None, None] + rows[None, :, None])
                & (rows[None, :, None] < cl[:, None, None]))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        attended = sum(o + x + 1 for o, n in zip(offs, cls) for x in range(n))
        prefix = sum(e for e, n in zip(ends, cls) if n)
        pages_read = sum(-(-e // ps) for e, n in zip(ends, cls) if n)
        nbytes = (prefix * kv_token_bytes(kv_bits, hkv, hd) + 4 * pages_read
                  + 2 * q.numel() * 4 + 8 * b)
        bms, by = bound(nbytes, 4 * hd * gq * hkv * attended, FP32_OPS_PER_S)
        case = (f"B={b} C={c} pages of {ps}, {max_pages}/seq, Hkv={hkv} "
                f"G={gq} D={hd} kv{kv_bits} offset={list(offs)} "
                f"chunk_len={list(cls)}")
        log(f"[kernel] flash_prefill_paged {case}: equals flash_prefill bit "
            f"for bit")
        main = (kv_bits == 8 and gq == 1 and ps == 64 and cls[1] == 128
                and hd == d)
        _record(results, "flash_prefill_paged", case, err, tol,
                timer(lambda: fp.flash_prefill_paged(q, pools[0], pools[1],
                                                     pt, off, cl, *pools[2:])),
                timer(lambda: fp.flash_prefill_paged_plain(
                    q, pools[0], pools[1], pt, off, cl, *pools[2:]), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_prefill.py:239",
                main)

    # the resume contract over pages: a one-token paged chunk is decode
    for kv_bits in (16, 8, 4):
        lens = (1, 64, 65, 512)
        pools, pt, _ = paged_case(torch, gen, lens, 32, d, 64, kv_bits, 8)
        q = torch.randn((b, 1, 32, d), generator=gen, device=dev)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        if not torch.equal(
                ops.flash_decode(q, pools, cur, page_table=pt),
                ops.flash_prefill(q, pools, cur - 1, torch.ones_like(cur),
                                  page_table=pt)):
            raise RuntimeError(f"kv{kv_bits}: a one-token flash_prefill_paged "
                               f"chunk differs from flash_decode_paged")
    log("[kernel] one-token flash_prefill_paged == flash_decode_paged "
        "(bit-equal, kv16/kv8/kv4)")
    # pages of 64, 8 per sequence, holding positions up to 428
    check_chunk_split(
        torch, "flash_prefill_paged", gen,
        lambda kv, o, n, qq: fp.flash_prefill_paged(qq, kv[0][0], kv[0][1],
                                                    kv[1], o, n, *kv[0][2:]),
        lambda kv_bits: paged_case(torch, gen, (128, 192, 300, 18), 32, d, 64,
                                   kv_bits, 8)[:2])


def _require_equal(torch, name, case, got, want) -> None:
    """Raise unless a kernel's result equals its plain version's bit for
    bit."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"{name} {case}: differs from its plain version")


def check_int8_kernels(torch, timer, results) -> None:
    """int8_matmul and w8a8_matmul at llama-7b's linear shapes and the
    512-token 4096 -> 4096 prefill on seeded int8 codes and positive
    per-channel scales, each bit-equal to its plain version, and rows at
    M = 4 (decode body) bit-equal to the same rows at M = 512 (wgmma body).
    Each log line names the body that ran, the time PERF.md recorded for
    the earlier body, the device work alone (also with the L2 left clean)
    and the host enqueue per call.
    Library yardstick: torch.matmul on the float32 operands with the
    scales folded in (and torch._int_mm at M = 512, logged)."""
    from repro_torch.kernels import int8_matmul as i8
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    for m, k, n in LINEAR_SHAPES + ((512, 4096, 4096),):
        x = torch.randn((m, k), generator=gen, device=dev)
        x_q = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                            dtype=torch.int8)
        x_scale = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 0.01
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        w_scale = torch.rand((n,), generator=gen, device=dev) * 0.05 + 0.01
        w_f = w_q.to(torch.float32) * w_scale
        x_f = x_q.to(torch.float32) * x_scale
        case = f"M={m} K={k} N={n}"
        main = (m, k, n) == (4, 4096, 11008)
        n_ops = 2 * m * k * n
        int_mm_ms = (timer(lambda: torch._int_mm(x_q, w_q)) if m > 16
                     else None)
        for name, call, plain, lib_call, nbytes, body in (
                ("int8_matmul",
                 lambda: i8.int8_matmul(x_q, x_scale, w_q, w_scale),
                 lambda: i8.int8_matmul_plain(x_q, x_scale, w_q, w_scale),
                 lambda: torch.matmul(x_f, w_f),
                 m * k + 4 * m + k * n + 4 * n + 4 * m * n,
                 i8.int8_body(x_q, w_q)),
                ("w8a8_matmul",
                 lambda: i8.w8a8_matmul(x, w_q, w_scale),
                 lambda: i8.w8a8_dynamic_plain(x, w_q, w_scale),
                 lambda: torch.matmul(x, w_f),
                 4 * m * k + k * n + 4 * n + 4 * m * n,
                 i8.w8a8_body(x, w_q))):
            got = call()
            _require_equal(torch, name, case, got, plain())
            if m > 4:
                # rows do not depend on M: decode body (M = 4) vs this one
                if name == "int8_matmul":
                    four = i8.int8_matmul(x_q[:4], x_scale[:4], w_q, w_scale)
                else:
                    four = i8.w8a8_matmul(x[:4], w_q, w_scale)
                _require_equal(torch, name, f"{case} rows 0-3 at M=4",
                               four, got[:4])
                log(f"[kernel] {name} {k}->{n}: rows at M=4 equal the first "
                    f"4 rows at M={m} (bit-equal)")
            bms, by = bound(nbytes, n_ops, INT8_OPS_PER_S)
            lib_ms = timer(lib_call)
            dev_ms = timer(call, hide_host=True)
            clean_ms = timer(call, hide_host=True, clean_l2=True)
            ms = timer(call)
            host_ms = timer.host_ms
            _record(results, name, case, 0.0, 0.0, ms,
                    timer(plain, reps=5), lib_ms, bms, by,
                    "src/repro/kernels/int8_matmul.py:"
                    + ("58" if name == "int8_matmul" else "111"), main)
            vs = f"{ms / lib_ms:.3f}x the time of torch.matmul"
            if int_mm_ms is not None:
                vs += (f", {ms / int_mm_ms:.3f}x torch._int_mm's "
                       f"{int_mm_ms:.4f} ms (int32 product only)")
            log(f"[kernel] {name} {case}: {body} body; {vs}; device work "
                f"alone {dev_ms:.4f} ms ({clean_ms:.4f} ms after a read-only "
                f"flush), host enqueue {host_ms:.4f} ms a call")
        del x, x_q, x_scale, w_q, w_scale, w_f, x_f


def check_quantize_pack(torch, timer, results) -> None:
    """quantize_pack at llama-7b's weight shapes (w4 g128 both ways, then
    w2, w8 and per-channel w4 on 4096 x 11008), opt-125m's fc1, the MoE
    archs' (qwen3-moe's q, k / v, o and one expert's up / gate and down;
    dbrx's expert up and down) and the quantized vlm and audio archs'
    (hubert-xlarge's 1280 x 1280, 1280 x 5120, 5120 x 1280; paligemma-3b's
    2048 x 2048, 2048 x 256, 2048 x 16384, 16384 x 2048): packed bytes,
    scales and zero points equal to the plain version's.  Each line also
    gives the call's device work alone (the enqueue hidden behind a device
    sleep), which tells the kernel's time from the launch floor at the
    small shapes.  No single PyTorch call computes it, so it has no
    library time.  Bound: 4 K N bytes read and K N bits / 8 + 8 N K / g
    written, or 7 float32 operations an element (max, min, quotient,
    round, add, two clamps).  The floor of the device-work timing (a
    one-element fill timed the same way) is logged first; then
    qwen3-moe's 128 experts of 2048 x 768 g128 packed in one launch must
    equal 128 single calls byte for byte, with its bound, device work
    alone and host enqueue beside the 128 single calls' wall time."""
    from repro_torch.kernels import quantize_pack as qp
    gen = torch.Generator(device="cuda").manual_seed(3)
    one = torch.empty(1, device="cuda")
    log(f"[kernel] quantize_pack timing floor: a one-element fill takes "
        f"{timer(lambda: one.zero_(), hide_host=True):.4f} ms of device "
        f"work alone, {timer(lambda: one.zero_()):.4f} ms after a flush")
    for k, n, bits, g in ((4096, 11008, 4, 128), (11008, 4096, 4, 128),
                          (4096, 11008, 2, 128), (4096, 11008, 8, 128),
                          (4096, 11008, 4, 0), (768, 3072, 4, 128),
                          (2048, 4096, 4, 128), (2048, 512, 4, 128),
                          (4096, 2048, 4, 128), (2048, 768, 4, 128),
                          (768, 2048, 4, 128), (6144, 10752, 4, 128),
                          (10752, 6144, 4, 128), (1280, 1280, 4, 128),
                          (1280, 5120, 4, 128), (5120, 1280, 4, 128),
                          (2048, 2048, 4, 128), (2048, 256, 4, 128),
                          (2048, 16384, 4, 128), (16384, 2048, 4, 128)):
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        case = f"K={k} N={n} w{bits} g{g}"
        got = qp.quantize_pack(w, bits=bits, group_size=g)
        want = qp.quantize_pack_plain(w, bits, g)
        for a, b in zip(got, want):
            _require_equal(torch, "quantize_pack", case, a, b)
        gs = g or k
        bms, by = bound(4 * k * n + k * n * bits // 8 + 8 * n * (k // gs),
                        7 * k * n, FP32_OPS_PER_S)
        call = lambda: qp.quantize_pack(w, bits=bits, group_size=g)
        alone = timer(call, hide_host=True)
        ms = timer(call)
        earlier = EARLIER_ALONE.get(case)
        earlier = ("" if earlier is None else
                   f" (PERF.md, earlier kernel: {earlier:.4f} ms)")
        log(f"[kernel] quantize_pack {case}: device work alone "
            f"{alone:.4f} ms{earlier}, {bms / alone:.1%} of the bound; host "
            f"enqueue {timer.host_ms:.4f} ms a call")
        _record(results, "quantize_pack", case, 0.0, 0.0, ms,
                timer(lambda: qp.quantize_pack_plain(w, bits, g), reps=5),
                None, bms, by, "src/repro/kernels/quantize_pack.py:115",
                (k, n, bits, g) == (4096, 11008, 4, 128))
        del w, got, want
    # a layer's stacked experts, one launch (serve/quantized.py::rtn_pack)
    b, k, n, g = 128, 2048, 768, 128
    w = torch.randn((b, k, n), generator=gen, device="cuda") * 0.02
    got = qp.quantize_pack(w, bits=4, group_size=g)
    t0 = time.perf_counter()
    single = [qp.quantize_pack(w[i], bits=4, group_size=g) for i in range(b)]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    for i, one_mat in enumerate(single):
        for a_, c_ in zip(got, one_mat):
            _require_equal(torch, "quantize_pack", f"expert {i} of {b}",
                           a_[i], c_)
    case = f"B={b} K={k} N={n} w4 g{g}"
    bms, _ = bound(b * (4 * k * n + k * n // 2 + 8 * n * (k // g)),
                   7 * b * k * n, FP32_OPS_PER_S)
    call = lambda: qp.quantize_pack(w, bits=4, group_size=g)
    alone = timer(call, hide_host=True)
    ms = timer(call)
    log(f"[kernel] quantize_pack {case} (qwen3-moe's experts of a layer, "
        f"one launch): equal to {b} single calls byte for byte; device work "
        f"alone {alone:.4f} ms, {bms / alone:.1%} of the bound {bms:.4g} ms "
        f"(bytes); flushed {ms:.4f} ms; host enqueue {timer.host_ms:.4f} ms "
        f"a call; the {b} single calls took {single_s * 1e3:.2f} ms of wall "
        f"time, synchronize included")
    del w, got, single


# ---------------------------------------------------------------------------
# 3. serving llama-7b W4A4 kv8 at full width
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "llama-7b", "--wbits", "4", "--group", "128",
              "--abits", "4", "--kvbits", "8", "--requests", "4",
              "--prompt-len", "128", "--max-new", "32", "--max-batch", "4",
              "--max-len", "512", "--seed", "0", "--device", "cuda"]
# Per-block teacher-forced check: a token row agrees when its largest
# difference is within ROW_TOL of its largest magnitude (a few float32
# ulps); a row whose a4 code an attention ulp moved differs by ~1e-2..1e-1.
# Such rows are rare (an ulp sits within reach of a rounding boundary for
# about one element in a million); a wrong kernel would fail most rows.
ROW_TOL = 1e-5
ROW_SHARE = 0.9
# a16 end-to-end: no rounding step between the kernels, so only float32
# summation order differs.
A16_TOL = 1e-3


def serve_w4a4(torch, params) -> tuple[dict, list, "torch.Tensor"]:
    """Phase 3; returns the launch counts, the greedy streams and the
    prompts (4, 128)."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(LAYERS)])
    if LAYERS != 32:
        log(f"[serve] depth cut to {LAYERS} of 32 layers")
    _lib.reset_launches()
    out = serve.serve(args, params)
    counts = dict(_lib.LAUNCHES)
    log(f"[serve] {out['cfg'].name} x{LAYERS} w4a4 g128 kv8: {out['generated']} "
        f"tokens in {out['seconds']:.3f} s = {out['tokens_per_s']:.2f} tok/s "
        f"(prefill of 4x128 included)")
    steps = out["step_seconds"]
    log(f"[serve] first step (admission + prefill + one decode) "
        f"{steps[0]:.4f} s; decode step median "
        f"{statistics.median(steps[1:]) * 1e3:.2f} ms over "
        f"{len(steps) - 1} steps (weight-stream bound per step 1.24 ms)")
    log(f"[serve] weight bytes {out['weight_bytes']}, KV bytes "
        f"{out['kv_bytes']}, launches {counts}")
    for name in ("w4a8_matmul", "flash_prefill", "flash_decode"):
        if counts[name] <= 0:
            raise RuntimeError(f"{name} not launched on the W4A4 path")
    reqs = out["requests"]
    vocab = out["cfg"].vocab_size
    if any(len(r.out_tokens) != 32 or not all(0 <= t < vocab
                                              for t in r.out_tokens)
           for r in reqs):
        raise RuntimeError("serve: a request did not produce 32 valid tokens")

    # teacher-forced checks against the plain versions on the card
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in reqs], dtype=torch.int32)
    gate_blockwise(torch, "serve", out, prompts, gen)
    a, p = teacher_forced_logits(torch, out, prompts, gen)
    if not (torch.isfinite(a).all() and a.shape == (4, 9, vocab)):
        raise RuntimeError("serve: non-finite or misshaped logits")
    rel = ((a - p).abs().max() / p.abs().max()).item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    stream = (a[:, :8].argmax(-1).cpu() == gen[:, :8]).float().mean().item()
    log(f"[serve] end-to-end teacher-forced logits, kernels vs plain over "
        f"{LAYERS} a4 layers: max|dlogit| / max|logit| {rel:.3e}, greedy "
        f"agreement {agree:.4f} (reported, not gated: a4 rounding amplifies "
        f"ulp differences layer over layer); engine stream vs "
        f"teacher-forced kernel argmax {stream:.4f}")
    if stream != 1.0:
        raise RuntimeError("serve: the engine's stream differs from the "
                           "teacher-forced kernel path")
    streams = [list(r.out_tokens) for r in reqs]
    del out, a, p
    torch.cuda.empty_cache()
    return counts, streams, prompts


def gate_blockwise(torch, tag, out, prompts, gen, **paged) -> None:
    """The per-block teacher-forced check, logged and gated at ROW_SHARE;
    an MoE model's routing flips are counted and gated at
    MOE_FLIP_SHARE."""
    share, n_rows, worst = blockwise_check(torch, out, prompts, gen, **paged)
    flips = share.pop("flip", None)
    n_routed = n_rows.pop("flip", 0)
    log(f"[{tag}] per-block teacher-forced kernels vs plain (prefill + "
        f"{paged.get('steps', 8)} decode steps, every layer): "
        f"{share['block']:.4f} of "
        f"{n_rows['block']} block-output token rows and {share['logit']:.4f} "
        f"of {n_rows['logit']} logit rows agree to {ROW_TOL:.0e} (gate "
        f"{ROW_SHARE} each); largest row difference {worst[0]:.3e} at "
        f"{worst[1]}")
    if flips is not None:
        log(f"[{tag}] routing flips (a token's top-{out['cfg'].top_k} "
            f"experts differ between the two paths' MoE inputs): "
            f"{round(flips * n_routed)} of {n_routed} routed token rows "
            f"(gate {MOE_FLIP_SHARE}); a flipped row, and the rows its "
            f"expert then drops, count against the row gate above")
        if not flips <= MOE_FLIP_SHARE:
            raise RuntimeError(f"{tag}: routing flips beyond "
                               f"{MOE_FLIP_SHARE} of the rows")
    if not min(share.values()) >= ROW_SHARE:
        raise RuntimeError(f"{tag}: blocks of the kernel path disagree with "
                           f"the plain versions")


def teacher_forced_logits(torch, out, prompts, gen, steps: int = 8):
    """Prefill logits and ``steps`` teacher-forced decode steps through the
    kernels (mode "auto") and through the plain versions."""
    from repro_torch.launch.serve import teacher_forced
    from repro_torch.serve.quantized import QuantizedModel
    return [teacher_forced(QuantizedModel(out["cfg"], out["qcfg"], mode=mode,
                                          device=out["model"].device),
                           out["params"], prompts, gen, steps, 512)
            for mode in ("auto", "plain")]


def page_digest(torch, cache, pages) -> bytes:
    """blake2b of the pool bytes (codes and scales, every layer) of
    ``pages``, in order."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for p in pages:
        for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            if t is not None:
                h.update(t[:, p].contiguous().view(torch.uint8).cpu()
                         .numpy().tobytes())
    return h.digest()


def blockwise_check(torch, out, prompts, gen, steps: int = 8,
                    page_size: int = 0, chunk: int = 0, prefix: int = 0):
    """Every block of the kernel path, fed the plain path's input hidden
    state, against the plain block: prefill (whole, or in chunks of
    ``chunk`` rows), then ``steps`` teacher-forced decode steps, over the
    linear cache or (``page_size``) over page pools with identical page
    tables.  With ``prefix`` (a page multiple that the prompts share) the
    pools share pages as the prefix cache does: row 0 prefills its whole
    prompt and registers it, the other rows adopt its first ``prefix``
    tokens' pages and prefill only the rest, resuming at ``prefix``; the
    shared pages' bytes must stay unchanged to the end.  The integer
    matmul kernel is bit-equal to its plain version, so both paths write
    identical K/V and the caches stay equal; only the attention kernels'
    summation order differs.  A token row therefore comes out equal to a
    few ulps, unless such an ulp moved one of its a4 activation codes by
    one step, which changes that row by up to ~10%.  The model may be the
    packed or the float one; an MoE model's routing is recorded on both
    paths and the rows whose experts differ are counted ("flip").  Returns
    (share of rows agreeing to ROW_TOL, rows, (largest row difference,
    where))."""
    import dataclasses
    from repro_torch.serve import kv_cache as kvc
    from repro_torch.models.init import layer
    cfg, params = out["cfg"], out["params"]
    dev = out["model"].device
    fields = {f.name: getattr(out["model"], f.name)
              for f in dataclasses.fields(out["model"])}
    models = [_recording(type(out["model"]))(**dict(fields, mode=m))
              for m in ("auto", "plain")]
    tokens = prompts.to(dev)
    b, t = tokens.shape
    pt = None
    host = prompts.numpy()
    if page_size:
        stores = [kvc.PagedCache(m, b, 512, page_size,
                                 prefix_cache=bool(prefix)) for m in models]
        for st in stores:
            for slot in range(1 if prefix else b):
                if not st.reserve(slot, t + steps, tokens=host[slot]):
                    raise RuntimeError("blockwise_check: pool too small")
        caches = [st.cache for st in stores]
        pt = caches[0].page_table
        rows = caches[0].num_pages * page_size
    else:
        caches = [m.init_cache(b, 512) for m in models]
    # counts and each comparison's largest difference stay on the card
    # until the end: no host sync per block, so the host enqueues ahead
    stats = {k: {"agree": [], "rows": 0} for k in ("block", "logit")}
    if cfg.num_experts:
        stats["flip"] = {"agree": [], "rows": 0}
    worst, wheres = [], []

    def compare(ya, yp, where, kind="block"):
        if kind == "block" and cfg.num_experts:
            ra, rp = (m.routes.pop() for m in models)
            stats["flip"]["agree"].append((ra != rp).any(-1).sum())
            stats["flip"]["rows"] += ra.shape[0]
        d = (ya - yp).abs().amax(-1).flatten()
        rel = d / yp.abs().amax(-1).flatten()
        stats[kind]["agree"].append((rel <= ROW_TOL).sum())
        stats[kind]["rows"] += rel.numel()
        worst.append(rel.max())
        wheres.append(where)

    def logits(ya, yp, where):
        compare(models[0]._head(params, ya), models[1]._head(params, yp),
                where + " logits", "logit")

    def prefill(c0, active):
        """One chunk from ``c0`` for the rows ``active`` (the others idle)."""
        c = min(chunk or t, t - c0)
        offset = torch.full((b,), c0, dtype=torch.int32, device=dev)
        cl = torch.zeros((b,), dtype=torch.int32, device=dev)
        cl[active] = c
        pos = offset[:, None] + torch.arange(c, device=dev)[None]
        if page_size:
            write = kvc.paged_chunk_write_index(kvc.chunk_write_dest(
                pt, offset, cl, c, page_size, rows // page_size), rows)
        else:
            write = kvc.chunk_write_index(offset, cl, c, 512)
        x = models[1]._embed(params, tokens[:, c0:c0 + c], pos)
        for i in range(cfg.num_layers):
            lp = layer(params["layers"], i)
            ya, yp = (m._block_prefill_chunk(lp, x, m._kv_entries(cc, i), pos,
                                             offset, cl, write, pt)
                      for m, cc in zip(models, caches))
            compare(ya[active], yp[active], f"prefill rows {c0}.. layer {i}")
            x = yp
        return ya[active, -1:], yp[active, -1:]

    if prefix:
        for c0 in range(0, t, chunk):
            prefill(c0, [0])
        for st in stores:
            st.register_prefix(0, host[0])
            for slot in range(1, b):
                if not st.reserve(slot, t + steps, tokens=host[slot]):
                    raise RuntimeError("blockwise_check: pool too small")
                if st.matched_tokens(slot) != prefix:
                    raise RuntimeError(f"blockwise_check: row {slot} matched "
                                       f"{st.matched_tokens(slot)} tokens, "
                                       f"not {prefix}")
        shared = stores[0].allocator.owned[0][:prefix // page_size]
        digest = [page_digest(torch, cc, shared) for cc in caches]
        for c0 in range(prefix, t, chunk):
            last = prefill(c0, list(range(1, b)))
    else:
        for c0 in range(0, t, chunk or t):
            last = prefill(c0, list(range(b)))
    if page_size and not torch.equal(pt, caches[1].page_table):
        raise RuntimeError("blockwise_check: page tables differ")
    logits(*last, "prefill")
    cur = torch.full((b,), t, dtype=torch.int32, device=dev)
    for step in range(steps):
        x = models[1]._embed(params, gen[:, step:step + 1].to(dev),
                             cur[:, None])
        if page_size:
            write = kvc.token_write_index(kvc.token_write_dest(
                pt, cur, page_size, rows // page_size), rows)
        for i in range(cfg.num_layers):
            lp = layer(params["layers"], i)
            if page_size:
                ya, yp = (m._block_decode_paged(
                    lp, x, m._kv_entries(cc, i), cur, pt, write,
                    cc.capacity) for m, cc in zip(models, caches))
            else:
                ya, yp = (m._block_decode(lp, x, m._kv_entries(cc, i), cur)
                          for m, cc in zip(models, caches))
            compare(ya, yp, f"decode step {step} layer {i}")
            x = yp
        logits(ya, yp, f"decode step {step}")
        cur = cur + 1
    same = all(torch.equal(a, p) for a, p in zip(
        models[0]._kv_entries(caches[0], slice(None)),
        models[1]._kv_entries(caches[1], slice(None))))
    if not same:
        raise RuntimeError("the kernel and plain paths wrote different K/V")
    if prefix and [page_digest(torch, cc, shared) for cc in caches] != digest:
        raise RuntimeError("blockwise_check: a shared page was written")
    rel = torch.stack(worst).cpu()
    nan = torch.isnan(rel).nonzero()
    i = int(nan[0, 0]) if len(nan) else int(rel.argmax())
    return ({k: int(torch.stack(v["agree"]).sum()) / v["rows"]
             for k, v in stats.items()},
            {k: v["rows"] for k, v in stats.items()},
            (float(rel[i]), wheres[i]))


_RECORDING: dict = {}


def _recording(cls):
    """``cls`` (a serving model class) whose MoE calls record their routing:
    each call appends the sorted expert ids (tokens, top_k) of its input to
    ``routes``."""
    if cls not in _RECORDING:
        import torch
        from repro_torch.models import moe

        class Recording(cls):
            def __post_init__(self):
                super().__post_init__()
                object.__setattr__(self, "routes", [])

            def _moe_apply(self, mp, h, split=False):
                ids = moe.route(mp["router"], h.reshape(-1, h.shape[-1]),
                                self.cfg.top_k)[2]
                self.routes.append(torch.sort(ids, dim=-1)[0])
                return super()._moe_apply(mp, h, split)

        _RECORDING[cls] = Recording
    return _RECORDING[cls]


def serve_a16(torch) -> dict:
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    argv = [a for a in SERVE_ARGS]
    argv[argv.index("--abits") + 1] = "16"
    argv[argv.index("--kvbits") + 1] = "16"
    argv[argv.index("--max-new") + 1] = "8"
    args = serve.build_parser().parse_args(argv + ["--layers",
                                                   str(A16_LAYERS)])
    _lib.reset_launches()
    out = serve.serve(args)
    counts = dict(_lib.LAUNCHES)
    log(f"[serve-a16] {out['cfg'].name} x{A16_LAYERS} (depth cut) w4a16 g128 kv16: "
        f"{out['generated']} tokens in {out['seconds']:.3f} s = "
        f"{out['tokens_per_s']:.2f} tok/s; launches {counts}")
    if counts["dequant_matmul"] <= 0 or counts["w4a8_matmul"] != 0:
        raise RuntimeError("the a16 path did not run dequant_matmul alone")
    import numpy as np
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in out["requests"]],
                       dtype=torch.int32)
    a, p = teacher_forced_logits(torch, out, prompts, gen)
    rel = ((a - p).abs().max() / p.abs().max()).item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    log(f"[serve-a16] teacher-forced logits (prefill + 8 decode steps), "
        f"kernels vs plain: max|dlogit| / max|logit| {rel:.3e} (tol "
        f"{A16_TOL:.0e}); greedy agreement {agree:.4f}")
    if not (torch.isfinite(a).all() and rel <= A16_TOL):
        raise RuntimeError("serve-a16: kernels and plain versions disagree")
    del out
    torch.cuda.empty_cache()
    return counts


def _with(argv: list, **flags) -> list:
    """SERVE_ARGS with ``--flag value`` pairs replaced or added
    (``value is True`` adds a bare switch)."""
    argv = list(argv)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if value is True:
            argv.append(flag)
        elif flag in argv:
            argv[argv.index(flag) + 1] = str(value)
        else:
            argv += [flag, str(value)]
    return argv


def _serve_paged_run(torch, tag, params, base=None, **flags):
    """One paged serving run through the CLI's entry point (``base``: the
    argv it changes, phase 3's by default); returns the output and its
    launch counts."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    base = base or _with(SERVE_ARGS, layers=LAYERS)
    args = serve.build_parser().parse_args(_with(base, paged=True, **flags))
    _lib.reset_launches()
    out = serve.serve(args, params)
    counts = dict(_lib.LAUNCHES)
    kv = out["engine"]._kv
    steps = out["step_seconds"]
    log(f"[{tag}] {out['cfg'].name} x{out['cfg'].num_layers} "
        f"{out['tag']} paged "
        f"(page {args.page_size}, {kv.allocator.num_pages} pages, prefill "
        f"chunk {args.prefill_chunk or 'whole prompt'}): {out['generated']} "
        f"tokens in {out['seconds']:.3f} s = {out['tokens_per_s']:.2f} tok/s; "
        f"decode step median {statistics.median(steps[1:]) * 1e3:.2f} ms over "
        f"{len(steps) - 1} steps; preemptions {out['preemptions']}")
    log(f"[{tag}] pool bytes {kv.cache.pool_bytes} (KV bytes with page "
        f"tables and lens {out['kv_bytes']}); peak pages in use "
        f"{kv.allocator.peak_in_use}; launches {counts}")
    bad = [r.rid for r in out["requests"]
           if r.status.name != "COMPLETED" or len(r.out_tokens) != args.max_new]
    if bad:
        raise RuntimeError(f"{tag}: requests {bad} did not complete with "
                           f"{args.max_new} tokens")
    kv.verify()
    if kv.allocator.num_free != kv.allocator.num_pages:
        raise RuntimeError(f"{tag}: pages leaked")
    return out, counts


def serve_paged(torch, params, base_streams) -> dict:
    """Phase 5: the phase-3 model and requests over page pools; (a) whole
    prompts into an automatic pool, (b) chunks of 64 into a 10-page pool."""
    import numpy as np
    out, counts = _serve_paged_run(torch, "paged-a", params, page_size=64)
    streams = [r.out_tokens for r in out["requests"]]
    if counts["flash_decode_paged"] <= 0 or counts["flash_decode"] != 0:
        raise RuntimeError("paged-a: decode did not run flash_decode_paged "
                           "alone")
    if streams != base_streams:
        raise RuntimeError("paged-a: the paged streams differ from the "
                           "linear streams of phase 3")
    log("[paged-a] greedy streams equal phase 3's linear streams token for "
        "token")
    del out
    out, counts_b = _serve_paged_run(torch, "paged-b", params, page_size=64,
                                     prefill_chunk=64, num_pages=10)
    if out["preemptions"] < 1:
        raise RuntimeError("paged-b: the 10-page pool never preempted")
    for name in ("flash_prefill_paged", "flash_decode_paged"):
        if counts_b[name] <= 0:
            raise RuntimeError(f"paged-b: {name} was never launched")
    if out["engine"]._kv.cache.pool_bytes != 173_015_040:
        raise RuntimeError("paged-b: the kv8 pool is not 10 pages x 64 x "
                           "8,448 B x 32 layers")
    streams_b = [r.out_tokens for r in out["requests"]]
    same = sum(a == b for s, t in zip(streams_b, base_streams)
               for a, b in zip(s, t))
    log(f"[paged-b] streams vs phase 3: {same} of {32 * len(base_streams)} "
        f"tokens equal, {sum(s == t for s, t in zip(streams_b, base_streams))} "
        f"of {len(base_streams)} streams identical (reported, not gated: "
        f"chunked and resumed prefill change the row count of float "
        f"reductions, and at a4 an ulp can move a code)")
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor(streams_b, dtype=torch.int32)
    gate_blockwise(torch, "paged-b", out, prompts, gen, page_size=64,
                   chunk=64)
    for name, n in counts_b.items():
        counts[name] += n
    del out
    torch.cuda.empty_cache()
    return counts


def serve_kv4(torch, params) -> dict:
    """Phase 6: the phase-3 model at kv4 over page pools, chunked."""
    import numpy as np
    out, counts = _serve_paged_run(torch, "kv4", params, kvbits=4,
                                   max_new=8, page_size=64, prefill_chunk=64)
    for name in ("flash_prefill_paged", "flash_decode_paged"):
        if counts[name] <= 0:
            raise RuntimeError(f"kv4: {name} was never launched")
    kv = out["engine"]._kv
    per_token = kv.cache.pool_bytes // (kv.allocator.num_pages * 64 * LAYERS)
    log(f"[kv4] pool bytes per token per layer {per_token} (kv8: 8448)")
    if per_token != 4608:
        raise RuntimeError("kv4: the pool is not 4,608 B per token per layer")
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in out["requests"]],
                       dtype=torch.int32)
    gate_blockwise(torch, "kv4", out, prompts, gen, page_size=64, chunk=64)
    del out
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 9. the Engine contract at llama-7b width: prefix sharing, the failure
#    model, sampling
# ---------------------------------------------------------------------------

# (a) 4 requests share a 320-token system prompt and add 64-token suffixes;
# pages and chunks of 64, so a prompt of 384 fills 6 pages and a match is
# capped at 5 (one token must stay novel); 7 pages a request hold the trace
# (c) runs phase 5b's pool of 10 pages
P9 = dict(system=320, suffix=64, page=64, chunk=64, max_new=32, max_len=512,
          short_new=8, tight_pages=10,
          sample=dict(temperature=0.8, top_k=40, seed=0))


def card_name(torch) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if not torch.cuda.is_available():
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def counted(counts: dict):
    """Zero the launch counters, run the block, add them to ``counts``."""
    from repro_torch.kernels import _lib
    _lib.reset_launches()
    yield
    for name, n in _lib.LAUNCHES.items():
        counts[name] += n


def _drain(eng, counts, prompts):
    """Submit ``prompts`` to an engine through its entry points and run it
    dry, counting launches; returns (requests, seconds)."""
    with counted(counts):
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=2000)
        return reqs, time.perf_counter() - t0


def _p9_run(model, params, counts, prompts, faults=None, **cfg):
    """One run of a fresh Engine; returns (engine, requests, seconds)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(model, params, ServeConfig(**cfg), faults=faults)
    return (eng, *_drain(eng, counts, prompts))


def _trace_pages(prompts) -> int:
    """Pages that hold every request of a trace at its final length."""
    return len(prompts) * (-(-(len(prompts[0]) + P9["max_new"] + 1)
                             // P9["page"]))


def _conserved(eng, tag) -> None:
    eng._kv.verify()
    al = eng._kv.allocator
    if al.num_free != al.num_pages or any(al.owned):
        raise RuntimeError(f"{tag}: pages leaked")


def _tok_s(reqs, secs) -> str:
    n = sum(len(r.out_tokens) for r in reqs)
    return f"{n} tokens in {secs:.3f} s = {n / secs:.2f} tok/s"


def prefix_prompts(vocab: int, n: int = 4) -> list:
    import numpy as np
    rng = np.random.default_rng(9)
    system = rng.integers(0, vocab, P9["system"])
    return [np.concatenate([system, rng.integers(0, vocab, P9["suffix"])])
            for _ in range(n)]


def engine_contract(torch, params, prompts3, greedy3) -> dict:
    """Phase 9 on phase 3's tree: (a) prefix sharing, (b) the failure
    model, (c) sampling; returns the launches of its engine runs."""
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(LAYERS)])
    cfg, qcfg, params, model, _ = serve.build_model(args, params)
    out = {"cfg": cfg, "qcfg": qcfg, "params": params, "model": model}
    card = card_name(torch)
    counts = zero_counts()
    base = prefix_phase(torch, out, counts, card)
    faults_phase(torch, out, counts, card, base, prompts3)
    sampling_phase(torch, out, counts, card, prompts3, greedy3)
    log(f"[engine] phase 9 wall time {time.perf_counter() - t_phase:.1f} s "
        f"({card}); launches {counts}")
    return counts


def prefix_phase(torch, out, counts, card) -> list:
    """(a): the no-sharing streams, then a cold and a replay wave on one
    prefix-sharing engine; returns the no-sharing streams."""
    import numpy as np
    t0 = time.perf_counter()
    model, params = out["model"], out["params"]
    prompts = prefix_prompts(out["cfg"].vocab_size)
    n_pages = _trace_pages(prompts)
    paged = dict(max_batch=len(prompts), max_len=P9["max_len"],
                 max_new=P9["max_new"], paged=True, page_size=P9["page"],
                 prefill_chunk=P9["chunk"], num_pages=n_pages)
    eng, reqs, secs = _p9_run(model, params, counts, prompts, **paged)
    base = [r.out_tokens for r in reqs]
    log(f"[prefix] no-sharing paged engine ({n_pages} pages of "
        f"{P9['page']}, chunks of {P9['chunk']}): {_tok_s(reqs, secs)} "
        f"({card})")
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(model, params, ServeConfig(prefix_cache=True, **paged))
    kv = eng._kv
    digests, matched = {}, []
    register, reserve = kv.register_prefix, kv.reserve

    def spy_register(slot, toks):
        before = set(kv._page_hash)
        register(slot, toks)
        for p in set(kv._page_hash) - before:
            digests[p] = page_digest(torch, kv.cache, [p])

    def spy_reserve(slot, length, tokens=None):
        ok = reserve(slot, length, tokens=tokens)
        if ok:
            matched.append(kv.matched_tokens(slot))
        return ok

    kv.register_prefix, kv.reserve = spy_register, spy_reserve
    waves = {}
    for wave in ("cold", "replay"):
        st0 = dict(eng.prefix_stats)
        del matched[:]
        reqs, secs = _drain(eng, counts, prompts)
        _conserved(eng, f"prefix {wave}")
        st = {k: eng.prefix_stats[k] - st0[k] for k in st0}
        streams = [r.out_tokens for r in reqs]
        log(f"[prefix] {wave} wave: {_tok_s(reqs, secs)} ({card}); "
            f"{st['hits']}/{st['lookups']} hits, matched per request "
            f"{matched}, {st['matched_tokens']} tokens adopted, "
            f"{st['prefilled_tokens']} prefilled; streams equal the "
            f"no-sharing engine's: {streams == base}; verify() passed")
        if streams != base:
            raise RuntimeError(f"prefix {wave}: streams differ from the "
                               f"no-sharing engine's")
        waves[wave] = (st, list(matched))
    n_full = len(prompts[0]) // P9["page"]
    cap = (len(prompts[0]) - 1) // P9["page"] * P9["page"]
    st, per = waves["replay"]
    want = {"lookups": len(prompts), "hits": len(prompts),
            "matched_tokens": len(prompts) * cap,
            "prefilled_tokens": len(prompts) * (len(prompts[0]) - cap)}
    if st != want or per != [cap] * len(prompts):
        raise RuntimeError(f"prefix replay: stats {st}, matched {per}; "
                           f"expected {want}, {cap} each (capped at "
                           f"{cap // P9['page']} of {n_full} full pages)")
    live = {p: d for p, d in digests.items() if p in kv._page_hash}
    changed = [p for p, d in live.items()
               if page_digest(torch, kv.cache, [p]) != d]
    log(f"[prefix] {len(live)} registered pages still mapped at drain, "
        f"blake2b of their pool bytes unchanged since register_prefix: "
        f"{not changed}")
    if changed or len(live) < cap // P9["page"]:
        raise RuntimeError(f"prefix: shared pages {changed} were written")
    del eng, kv
    prompts_t = torch.from_numpy(np.stack(prompts))
    gen = torch.tensor(base, dtype=torch.int32)
    gate_blockwise(torch, "prefix", out, prompts_t, gen, steps=4,
                   page_size=P9["page"], chunk=P9["chunk"], prefix=cap)
    log(f"[prefix] part (a) wall time {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return base


def faults_phase(torch, out, counts, card, base, prompts3) -> None:
    """(b): NaN quarantine under live sharing, then one short trace per
    fault (deadline, callback, cancel in each phase, allocator faults up
    to the watchdog), then the unscrubbed-page report."""
    from repro_torch.serve import faults as flt
    from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
    t0 = time.perf_counter()
    model, params = out["model"], out["params"]
    prompts = prefix_prompts(out["cfg"].vocab_size)
    plan = flt.FaultPlan(flt.Fault(point=flt.NAN_LOGITS, rid=2,
                                   after_step=1 << 30))
    eng = Engine(model, params, ServeConfig(
        max_batch=len(prompts), max_len=P9["max_len"], max_new=P9["max_new"],
        paged=True, page_size=P9["page"], prefill_chunk=P9["chunk"],
        num_pages=_trace_pages(prompts), prefix_cache=True,
        integrity_checks=True), faults=plan)
    (writer,), _ = _drain(eng, counts, prompts[:1])
    # the three readers adopt the writer's prompt pages in one step (live
    # sharing, refcount 3); the fault fires a few decode steps after their
    # three final chunks
    plan.faults[0].after_step = eng._step_idx + 3 + min(8, P9["max_new"] // 4)
    readers, _ = _drain(eng, counts, prompts[1:])
    victim = readers[1]
    matched0 = eng.prefix_stats["matched_tokens"]
    (late,), _ = _drain(eng, counts, prompts[2:3])
    late_matched = eng.prefix_stats["matched_tokens"] - matched0
    _conserved(eng, "quarantine")
    S = RequestStatus
    # each co-reader names the reader whose quarantine failed it: the
    # victim, or (the quarantine recurses, as the reference's does) a
    # co-reader that failed before it
    named = {int(r.error.rsplit("rid=", 1)[1].split()[0]) for r in readers
             if r is not victim and r.error and "poisoned by rid=" in r.error}
    log(f"[faults] NaN in rid {victim.rid} (a reader of 3 sharing the "
        f"writer's {P9['system'] // P9['page']} prompt pages) at step "
        f"{plan.log[0][0] if plan.log else None}: writer {writer.status.name}"
        f"; readers {[(r.rid, r.status.name, len(r.out_tokens), r.error) for r in readers]}"
        f"; late resubmission {late.status.name}, {late_matched} tokens "
        f"matched (the quarantine unmapped the prefix); pool conserved "
        f"under integrity checks")
    ok = (writer.status is S.COMPLETED and writer.out_tokens == base[0]
          and victim.status is S.FAILED_NAN and "non-finite" in victim.error
          and all(r.status is S.FAILED_NAN for r in readers)
          and named <= {r.rid for r in readers}
          and victim.rid in named and len(named) == len(readers) - 1
          and all(r.out_tokens == base[i + 1][:len(r.out_tokens)]
                  for i, r in enumerate(readers))
          and late.status is S.COMPLETED and late.out_tokens == base[2]
          and late_matched == 0)
    if not ok:
        raise RuntimeError("faults: the NaN quarantine under sharing broke "
                           "its contract")
    short_traces(torch, out, counts, card, prompts3)
    unscrubbed_report(torch, card)
    log(f"[faults] part (b) wall time {time.perf_counter() - t0:.1f} s "
        f"({card})")


def short_traces(torch, out, counts, card, prompts) -> None:
    """One short trace per remaining fault on phase 3's prompts (batch 2,
    pages and chunks of 64, 8 new tokens): the surviving streams must
    equal the unfaulted run's."""
    from repro_torch.serve import faults as flt
    from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
    S = RequestStatus
    model, params = out["model"], out["params"]
    cfg = dict(max_batch=2, max_len=P9["max_len"], max_new=P9["short_new"],
               paged=True, page_size=P9["page"], prefill_chunk=P9["chunk"],
               integrity_checks=True, watchdog_steps=4)
    _, reqs, _ = _p9_run(model, params, counts, prompts, **cfg)
    want = [r.out_tokens for r in reqs]

    def faulted(tag, fault, expect):
        plan = flt.FaultPlan(fault)
        eng, reqs, secs = _p9_run(model, params, counts, prompts, plan, **cfg)
        _conserved(eng, tag)
        got = [(r.status, r.out_tokens) for r in reqs]
        bad = [i for i, (st, toks) in enumerate(got)
               if st is not expect.get(i, S.COMPLETED)
               or (st is S.COMPLETED and toks != want[i])
               or toks != want[i][:len(toks)]]
        log(f"[faults] {tag}: {[(st.name, len(t)) for st, t in got]}, "
            f"{plan.fired()} firing(s), survivors equal the unfaulted "
            f"run: {not bad} ({secs:.2f} s, {card})")
        if bad:
            raise RuntimeError(f"faults {tag}: requests {bad} broke the "
                               f"contract")
        return reqs

    faulted("deadline", flt.Fault(point=flt.DEADLINE, rid=1, after_step=3),
            {1: S.FAILED_DEADLINE})
    faulted("callback", flt.Fault(point=flt.CALLBACK_RAISE, rid=2,
                                  after_step=1), {2: S.FAILED_CALLBACK})
    faulted("alloc x3", flt.Fault(point=flt.ALLOC_FAIL, count=3,
                                  after_step=1), {})
    reqs = faulted("alloc to the watchdog",
                   flt.Fault(point=flt.ALLOC_FAIL, count=0),
                   {i: S.FAILED_POOL for i in range(len(prompts))})
    if not all("watchdog" in r.error for r in reqs):
        raise RuntimeError("faults: the watchdog did not end the starved "
                           "requests")
    # cancel in each phase: queued, mid-prefill, decoding
    eng = Engine(model, params, ServeConfig(**cfg))
    with counted(counts):
        reqs = [eng.submit(p) for p in prompts]
        eng.step()                   # rid 0 mid-prefill, rid 1 waits in slot
        phases = {"queued": eng.cancel(reqs[3].rid)}
        eng.step()                   # rid 0 decodes, rid 1 still mid-prefill
        phases["mid-prefill"] = (eng._prefill_prog[1] is not None
                                 and eng.cancel(reqs[1].rid))
        phases["decoding"] = (eng._prefill_prog[0] is None
                              and 0 < len(reqs[0].out_tokens) < cfg["max_new"]
                              and eng.cancel(reqs[0].rid))
        eng.run(max_steps=200)
    _conserved(eng, "cancel")
    log(f"[faults] cancel in each phase {phases}: "
        f"{[(r.status.name, len(r.out_tokens)) for r in reqs]} ({card})")
    if not (all(phases.values())
            and [r.status for r in reqs] == [S.CANCELLED, S.CANCELLED,
                                              S.COMPLETED, S.CANCELLED]
            and reqs[2].out_tokens == want[2]
            and reqs[0].out_tokens == want[0][:len(reqs[0].out_tokens)]):
        raise RuntimeError("faults: cancel broke the contract")


def unscrubbed_report(torch, card) -> None:
    """Information, not a gate: a NaN scale left at masked positions of a
    recycled kv8 page, read by its next tenant (10 valid tokens of 64)
    through the paged decode kernel and through its plain version."""
    import numpy as np
    from repro_torch.kernels import flash_decode as fd
    rng = np.random.default_rng(0)
    hkv, d, ps = 32, 128, 64
    k, v = (torch.from_numpy(rng.integers(-127, 128, (2, ps, hkv, d)).astype(
        np.int8)).cuda() for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((2, ps, hkv)) * 0.02 + 1e-3)
                               .astype(np.float32)).cuda() for _ in range(2))
    for s in (ks, vs):
        s[1, 10:] = float("nan")             # stale poison past the tenant
    q = torch.from_numpy(rng.standard_normal((1, hkv, 1, d)).astype(
        np.float32)).cuda()
    pt = torch.tensor([[1]], dtype=torch.int32, device="cuda")
    cur = torch.tensor([10], dtype=torch.int32, device="cuda")
    kern = fd.flash_decode_paged(q, k, v, pt, cur, ks, vs)
    plain = fd.flash_decode_paged_plain(q, k, v, pt, cur, ks, vs)
    log(f"[faults] unscrubbed recycled page (NaN scales at positions 10-63, "
        f"the tenant's length 10; reported, not gated): kernel output finite "
        f"{bool(torch.isfinite(kern).all())}, plain version output finite "
        f"{bool(torch.isfinite(plain).all())} ({card})")


def sampling_phase(torch, out, counts, card, prompts, greedy) -> None:
    """(c): phase 3's requests sampled at temperature 0.8, top-k 40, seed 0
    over the linear engine (twice) and phase 5b's preempting 10-page pool;
    top_k = 1 against phase 3's greedy streams."""
    t0 = time.perf_counter()
    model, params = out["model"], out["params"]
    base = dict(max_batch=len(prompts), max_len=P9["max_len"],
                max_new=P9["max_new"])
    runs = {}
    for tag, extra in (
            ("linear", P9["sample"]), ("linear again", P9["sample"]),
            ("paged", dict(P9["sample"], paged=True, page_size=P9["page"],
                           num_pages=P9["tight_pages"],
                           prefill_chunk=P9["chunk"])),
            ("top_k 1", dict(P9["sample"], top_k=1))):
        eng, reqs, secs = _p9_run(model, params, counts, prompts,
                                  **base, **extra)
        runs[tag] = [r.out_tokens for r in reqs]
        log(f"[sample] {tag} {extra}: {_tok_s(reqs, secs)}, preemptions "
            f"{eng.preemptions} ({card})")
        if tag.startswith("paged"):
            preempted = eng.preemptions
    lin = runs["linear"]
    same = sum(a == b for s, t in zip(runs["paged"], lin)
               for a, b in zip(s, t))
    checks = {"linear == paged": runs["paged"] == lin,
              "paged preempted": preempted >= 1,
              "linear reproduces": runs["linear again"] == lin,
              "top_k 1 == phase 3 greedy": runs["top_k 1"] == greedy,
              "sampled != greedy": lin != greedy}
    log(f"[sample] {checks}; paged vs linear {same} of "
        f"{sum(map(len, lin))} tokens equal; part (c) wall time "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    if not all(checks.values()):
        raise RuntimeError(f"sample: {[k for k, v in checks.items() if not v]}"
                           f" failed")


# ---------------------------------------------------------------------------
# 7. the three kernels no serving path runs, over the served tree
# ---------------------------------------------------------------------------

MESH_LAYERS = 8          # 17b's depth, cut from 32 (full width): two ranks
#                          share the card and stage every collective
#                          through the host
MESH_MODEL = 2           # 17b's "model" axis: two ranks on the one card
MESH_DEVICE = "cuda"     # "cpu" rehearses the phase (gloo, micro sizes)


def mesh_phase(torch, params, streams) -> dict:
    """Phase 17 on phase 3's tree: (a) ``Engine(mesh=make_serving_mesh(1,
    1))`` over NCCL with a world of one, phase 5a's requests (pages of 64,
    whole prompts), streams equal phase 5a's (= phase 3's), memory_report
    the unsharded bytes on one device; (b) a (1, 2) mesh of two ranks on
    the one card over gloo, started by ``launch/serve --mesh-model 2
    --share-cards`` on the tree cut to MESH_LAYERS (saved once by
    ``checkpoints.save``, each rank loading it with ``--load-packed`` and
    cutting its shard), phase 5b's pool (chunks of 64, 10 pages: must
    preempt): each rank's streams, statuses and preemptions equal the
    unsharded engine's on the same tree and depth, and each rank holds
    less weight and KV bytes.  Returns the launches of both parts' serving
    runs (each rank's counted in its process).  (c) runs inside phase 14
    (:class:`MeshMoe`), (d)-(e) beside phase 11
    (:class:`MeshFamilies`)."""
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    mesh_single(torch, params, streams, counts, card)
    mesh_two_ranks(torch, params, counts, card)
    log(f"[mesh] phase 17 (a)-(b) wall time "
        f"{time.perf_counter() - t_phase:.1f} s ({card}); launches {counts}")
    return counts


def mesh_single(torch, params, streams, counts, card) -> None:
    """(a) the 1 x 1 mesh."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve.engine import Engine
    t0 = time.perf_counter()
    mesh = make_serving_mesh(1, 1, device=MESH_DEVICE)
    backend = dist.get_backend()
    args = serve.build_parser().parse_args(
        _with(SERVE_ARGS, layers=LAYERS, paged=True, page_size=64))
    try:
        if backend != ("nccl" if MESH_DEVICE == "cuda" else "gloo"):
            raise RuntimeError(f"mesh-a: a world of one on {MESH_DEVICE} "
                               f"chose {backend}")
        with counted(counts):
            out = serve.serve(args, params, mesh=mesh)
    finally:
        dist.destroy_process_group()
    got = [list(r.out_tokens) for r in out["requests"]]
    if got != streams:
        raise RuntimeError("mesh-a: the 1 x 1 mesh's streams differ from "
                           "phase 5a's")
    rep = out["engine"].memory_report()
    plain = Engine(out["model"], params, serve.serve_config(args)
                   ).memory_report()
    if rep != plain or rep["device_count"] != 1:
        raise RuntimeError(f"mesh-a: memory_report {rep} is not the "
                           f"unsharded {plain}")
    steps = out["step_seconds"]
    log(f"[mesh-a] Engine(mesh=make_serving_mesh(1, 1)), backend {backend}, "
        f"llama-7b x{LAYERS} w4a4 g128 kv8 paged: streams equal phase 5a's "
        f"token for token; memory_report {rep} (unsharded); decode step "
        f"median {statistics.median(steps[1:]) * 1e3:.2f} ms; "
        f"{time.perf_counter() - t0:.1f} s ({card})")


def _depth(tree, n: int):
    """The first ``n`` layers of a stacked layer tree (views)."""
    if isinstance(tree, dict):
        return {k: _depth(v, n) for k, v in tree.items()}
    return tree[:n]


def mesh_two_ranks(torch, params, counts, card) -> None:
    """(b) the (1, 2) mesh: two ranks on one card."""
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.train import checkpoints
    t0 = time.perf_counter()
    tree = dict(params, layers=_depth(params["layers"], MESH_LAYERS))
    argv = _with(SERVE_ARGS, layers=MESH_LAYERS, paged=True, page_size=64,
                 prefill_chunk=64, num_pages=POOL_PAGES)
    with counted(counts):
        base = serve.serve(serve.build_parser().parse_args(argv), tree)
    want = {"streams": [list(r.out_tokens) for r in base["requests"]],
            "statuses": [r.status.name for r in base["requests"]],
            "preemptions": base["preemptions"]}
    if want["preemptions"] < 1:
        raise RuntimeError("mesh-b: the unsharded 10-page pool never "
                           "preempted")
    with tempfile.TemporaryDirectory() as tmp:
        checkpoints.save(tmp, 0, tree)
        t1 = time.perf_counter()
        res = serve.serve_on_mesh(serve.build_parser().parse_args(
            argv + ["--load-packed", tmp, "--mesh-data", "1", "--mesh-model",
                    str(MESH_MODEL), "--share-cards"]))
        t_ranks = time.perf_counter() - t1
    steps = base["step_seconds"]
    log(f"[mesh-b] unsharded llama-7b x{MESH_LAYERS} (depth cut from 32, full "
        f"width) w4a4 g128 kv8, chunks of 64 into {POOL_PAGES} pages: "
        f"preemptions {want['preemptions']}, statuses {want['statuses']}; "
        f"decode step median {statistics.median(steps[1:]) * 1e3:.2f} ms; "
        f"weight bytes {base['weight_bytes']}, KV bytes {base['kv_bytes']}")
    for rank in res["ranks"]:
        got = {k: rank[k] for k in want}
        if got != want:
            raise RuntimeError(f"mesh-b: rank {rank['rank']} served {got}, "
                               f"the unsharded engine {want}")
        mem = rank["memory"]
        if not (mem["weight_bytes"] < base["weight_bytes"]
                and mem["kv_bytes"] < base["kv_bytes"]
                and mem["device_count"] == MESH_MODEL):
            raise RuntimeError(f"mesh-b: rank {rank['rank']} holds {mem}, "
                               f"not less than the unsharded engine")
        launched = {k: v for k, v in rank["launches"].items() if v}
        require_launched(rank["launches"], ("w4a8_matmul",
                                            "flash_prefill_paged",
                                            "flash_decode_paged"),
                         f"mesh-b rank {rank['rank']}")
        _add(counts, {k: v for k, v in rank["launches"].items()
                      if k in counts})
        rs = rank["step_seconds"]
        log(f"[mesh-b] rank {rank['rank']} of (1, {MESH_MODEL}) "
            f"({rank['backend']}, coordinate {rank['coordinate']}): streams, "
            f"statuses and preemptions equal the unsharded engine's; weight "
            f"bytes {mem['weight_bytes']}, KV bytes {mem['kv_bytes']}; decode "
            f"step median {statistics.median(rs[1:]) * 1e3:.2f} ms over "
            f"{len(rs) - 1} steps; launches {launched}; {card}")
    log(f"[mesh-b] two ranks on one card: {t_ranks:.1f} s from the start of "
        f"the ranks to their last summary (process start, loading and "
        f"cutting the tree, serving); part (b) {time.perf_counter() - t0:.1f} "
        f"s ({card})")


MESH_MOE_LAYERS = 8      # 17c's depth, cut from 48 (full width)
MESH_REC = {"mamba2-1.3b": 8, "recurrentgemma-2b": 6}   # 17d, from 48 / 26
MESH_VLM_LAYERS = 6      # 17e's depth, cut from 18
MESH_TOL = 1e-4          # teacher-forced logits, of the largest unsharded
MESH_FLAGS = ["--mesh-data", "1", "--mesh-model", str(MESH_MODEL),
              "--share-cards"]


class MeshRanks:
    """``jobs`` on a (1, MESH_MODEL) mesh of ranks sharing the card over
    gloo (:func:`mesh_rank_main`, one process a rank), started at once and
    run beside the main process; :meth:`finish` waits and returns each
    rank's results, rank 0's teacher-forced logits (and an MoE's routes)
    loaded from ``<tag>.pt``.  A rank that fails fails the script."""

    def __init__(self, jobs: list, tmp: Path):
        from repro_torch.launch.mesh import free_port
        self.tmp, self.t0 = tmp, time.perf_counter()
        spec = self.tmp / "mesh-jobs.json"
        spec.write_text(json.dumps({"jobs": jobs, "out": str(self.tmp),
                                    "device": MESH_DEVICE,
                                    "prefix": [VLM_TEXT, REC_NEW]}))
        port = free_port()
        self.procs = [start_child(
            [sys.executable, "-c", f"import chip_smoke; "
             f"chip_smoke.mesh_rank_main({r}, {MESH_MODEL}, {port}, "
             f"{str(spec)!r})"],
            cwd=ROOT, env=child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_MODEL)]

    def finish(self, torch) -> tuple:
        """(each rank's results, {tag: rank 0's saved tensors})."""
        import shutil
        outs = []
        try:
            for proc in self.procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in self.procs:
                proc.kill()
        self.seconds = time.perf_counter() - self.t0
        try:
            for r, (proc, out) in enumerate(zip(self.procs, outs)):
                if proc.returncode != 0:
                    for line in out.splitlines()[-40:]:
                        log(f"[mesh rank {r}] {line}")
                    raise RuntimeError(f"mesh rank {r} failed (exit "
                                       f"{proc.returncode})")
            ranks = [json.loads((self.tmp / f"mesh-rank{r}.json").read_text())
                     for r in range(MESH_MODEL)]
            saved = {tag: torch.load(self.tmp / f"{tag}.pt")
                     for tag in ranks[0]}
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        return ranks, saved


def _mesh_tmp() -> Path:
    import tempfile
    return Path(tempfile.mkdtemp(prefix="mesh-"))


def prefix_forced(torch, model, params, text: int, new: int):
    """17e: the prefix prefill of 2 x num_prefix seeded prefix embeddings
    and 2 x ``text`` seeded tokens, then ``new - 1`` teacher-forced decode
    steps on seeded tokens; their logits (2, new, vocab)."""
    import numpy as np
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prefix = torch.from_numpy((0.02 * rng.standard_normal(
        (2, cfg.num_prefix, cfg.d_model))).astype(np.float32)).to(
            model.device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, text)
                                           ).astype(np.int32))
    gen = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, new)
                                        ).astype(np.int32))
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": tokens,
                                           "prefix_embeds": prefix},
                                  cfg.num_prefix + text + new)
        seq = [lg]
        for i in range(new - 1):
            lg, cache = model.decode_step(params, gen[:, i:i + 1], cache)
            seq.append(lg)
    return torch.cat(seq, 1)


def routed_forced(torch, model, params, prompts, streams, max_len) -> dict:
    """Teacher-forced logits of ``model`` on ``prompts`` and ``streams``
    (on the CPU) and, for an MoE, the sorted expert ids of every routed
    token row of its MoE calls (``routes``, (rows, top_k))."""
    import dataclasses
    from repro_torch.launch.serve import teacher_forced
    gen = torch.as_tensor(streams, dtype=torch.int32)
    p = torch.as_tensor([list(x) for x in prompts], dtype=torch.int32)
    if model.cfg.num_experts:
        fields = {f.name: getattr(model, f.name)
                  for f in dataclasses.fields(model)}
        model = _recording(type(model))(**fields)
    out = {"logits": teacher_forced(model, params, p, gen, gen.shape[1] - 1,
                                    max_len).cpu()}
    if model.cfg.num_experts:
        out["routes"] = torch.cat(model.routes).cpu()
    return out


def mesh_rank_main(rank: int, world: int, port: int, spec: str) -> None:
    """One rank of :class:`MeshRanks`: join the gloo group, run each job on
    the (1, world) mesh, write ``mesh-rank<r>.json`` (and rank 0's
    tensors).  A "serve" job drives ``launch/serve``'s serving run on the
    mesh (its launches counted), then teacher-forces the served model on
    one device's streams; a "prefix" job builds ``Engine(mesh=...)`` and
    runs the vlm's prefix prefill on the rank's shards."""
    die_with_parent()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_world, make_serving_mesh
    from repro_torch.serve.engine import Engine
    job_spec = json.loads(Path(spec).read_text())
    out_dir, device = Path(job_spec["out"]), job_spec["device"]
    if device == "cuda":
        _lib.lib()
    else:
        torch.set_num_threads(1)
    backend = init_world(rank, world, port, device)
    results = {}
    try:
        mesh = make_serving_mesh(1, world, device=device)
        for job in job_spec["jobs"]:
            args = serve.build_parser().parse_args(job["argv"])
            res = {"backend": backend, "rank": rank}
            if job["kind"] == "serve":
                _lib.reset_launches()
                out = serve.serve(args, mesh=mesh)
                eng = out["engine"]
                res.update(launches=dict(_lib.LAUNCHES),
                           streams=_streams(out),
                           statuses=[r.status.name for r in out["requests"]],
                           step_seconds=out["step_seconds"],
                           memory=eng.memory_report())
                if eng.model.cfg.num_experts:
                    w = eng.params["layers"]["moe"]["w_up"]
                    res["experts"] = int(getattr(w, "packed", w).shape[1])
                saved = routed_forced(torch, eng.model, eng.params,
                                      out["prompts"], job["streams"],
                                      args.max_len)
                del out
            else:
                _, _, params, model, _ = serve.build_model(args)
                eng = Engine(model, params, serve.serve_config(args),
                             mesh=mesh)
                del params
                saved = {"logits": prefix_forced(
                    torch, eng.model, eng.params, *job_spec["prefix"]).cpu()}
                res["memory"] = eng.memory_report()
            if rank == 0:
                torch.save(saved, out_dir / f"{job['tag']}.pt")
            results[job["tag"]] = res
            del eng, saved
            if device == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out_dir / f"mesh-rank{rank}.json").write_text(json.dumps(results))


def _mesh_gate(tag, ranks, got, ref, want, base_bytes: int,
               exact: bool = False) -> dict:
    """17c-e's gates for ``tag``: every rank served the same streams (where
    it served), all completed, and each rank holds fewer weight bytes than
    one device; rank 0's teacher-forced logits (``got``) within MESH_TOL of
    one device's (``ref``) at every row.  ``exact``: the streams equal one
    device's and no routed row's top-k differs.  Returns the largest row
    difference, the routing flips and the greedy agreement."""
    import numpy as np
    for r in ranks:
        mem = r[tag]["memory"]
        if not (mem["weight_bytes"] < base_bytes
                and mem["device_count"] == MESH_MODEL):
            raise RuntimeError(f"{tag}: rank {r['rank']} holds {mem}, not "
                               f"less than one device's {base_bytes}")
    lg, want_lg = got["logits"], ref["logits"]
    g = {"rel": ((lg - want_lg).abs().max() / want_lg.abs().max()).item(),
         "agree": None, "flips": None}
    if "routes" in ref:
        g["routed"] = ref["routes"].shape[0]
        g["flips"] = int((got["routes"] != ref["routes"]).any(-1).sum())
    if not (bool(lg.isfinite().all()) and g["rel"] <= MESH_TOL
            and not (exact and g["flips"])):
        raise RuntimeError(f"{tag}: teacher-forced logits on the mesh differ "
                           f"from one device's by {g['rel']:.3e} (tol "
                           f"{MESH_TOL:.0e}); routing flips {g['flips']}")
    first = ranks[0][tag]
    if "streams" in first:
        if any(r[tag]["streams"] != first["streams"] for r in ranks):
            raise RuntimeError(f"{tag}: the ranks served different streams")
        if any(st != "COMPLETED" for st in first["statuses"]):
            raise RuntimeError(f"{tag}: statuses {first['statuses']}")
        if exact and first["streams"] != want:
            raise RuntimeError(f"{tag}: the mesh's streams differ from one "
                               f"device's")
        g["agree"] = float(np.mean(np.array(first["streams"])
                                   == np.array(want)))
    return g


class MeshFamilies:
    """17d-e: mamba2-1.3b and recurrentgemma-2b float at full width (depths
    MESH_REC) through ``launch/serve --fp``'s serving run on two ranks
    sharing the card, held to one device's teacher-forced logits within
    MESH_TOL, greedy agreement counted, a rank holding half the ssm heads
    / rnn channels; paligemma-3b's prefix prefill (256 slots + VLM_TEXT
    tokens and REC_NEW - 1 decode steps) at MESH_VLM_LAYERS within
    MESH_TOL.  The constructor makes one device's references and starts
    the ranks, which run beside the main process until :meth:`finish`
    gates them and returns the launches of the serving runs (one device's
    and each rank's)."""

    def __init__(self, torch, card):
        from repro_torch.launch import serve
        from repro_torch.serve.engine import tree_bytes
        self.card, self.t0 = card, time.perf_counter()
        self.counts = zero_counts()
        jobs, self.refs = [], {}
        for arch, layers in MESH_REC.items():
            argv = _with(SERVE_ARGS, arch=arch, layers=layers, fp=True)
            out, c = _counted_serve(argv, None)
            _add(self.counts, c)
            want = _streams(out)
            self.refs[arch] = (
                routed_forced(torch, out["model"], out["params"],
                              out["prompts"], want,
                              out["engine"].cfg.max_len),
                want, out["weight_bytes"], out["kv_bytes"],
                statistics.median(out["step_seconds"][1:]))
            jobs.append({"tag": arch, "kind": "serve",
                         "argv": argv + MESH_FLAGS, "streams": want})
            del out
        argv = _with(SERVE_ARGS, arch=VLM_ARCH, layers=MESH_VLM_LAYERS,
                     fp=True, max_batch=2)
        cfg, _, params, model, _ = serve.build_model(
            serve.build_parser().parse_args(argv))
        self.refs[VLM_ARCH] = (
            {"logits": prefix_forced(torch, model, params, VLM_TEXT,
                                     REC_NEW).cpu()},
            None, tree_bytes(params), 0, None)
        self.prefix = cfg.num_prefix
        del params, model
        jobs.append({"tag": VLM_ARCH, "kind": "prefix",
                     "argv": argv + MESH_FLAGS})
        if MESH_DEVICE == "cuda":
            torch.cuda.empty_cache()
        self.ranks = MeshRanks(jobs, _mesh_tmp())
        log(f"[mesh-d/e] one device's references in "
            f"{time.perf_counter() - self.t0:.1f} s; two ranks started")

    def finish(self, torch) -> dict:
        card = self.card
        ranks, saved = self.ranks.finish(torch)
        for tag, (ref, want, wbytes, kvbytes, step) in self.refs.items():
            g = _mesh_gate(tag, ranks, saved[tag], ref, want, wbytes)
            r0 = ranks[0][tag]
            mem = r0["memory"]
            if tag == VLM_ARCH:
                log(f"[mesh-e] {tag} x{MESH_VLM_LAYERS} (depth cut from 18, "
                    f"full width) float on (1, {MESH_MODEL}) ({r0['backend']}"
                    f", two ranks on the card): prefix {self.prefix} + text "
                    f"{VLM_TEXT} prefilled and {REC_NEW - 1} decode steps, "
                    f"teacher-forced logits within {g['rel']:.3e} of one "
                    f"device's largest logit (tol {MESH_TOL:.0e}); a "
                    f"rank's weight bytes "
                    f"{mem['weight_bytes']} of {wbytes}; {card}")
                continue
            if not mem["kv_bytes"] < kvbytes:
                raise RuntimeError(f"{tag}: a rank's state bytes "
                                   f"{mem['kv_bytes']} are not below one "
                                   f"device's {kvbytes}")
            for rank in ranks:
                _add(self.counts, {k: v for k, v in
                                   rank[tag]["launches"].items()
                                   if k in self.counts})
            rs = r0["step_seconds"]
            log(f"[mesh-d] {tag} x{MESH_REC[tag]} (depth cut, full width) "
                f"float on (1, {MESH_MODEL}) ({r0['backend']}): "
                f"teacher-forced logits on one device's streams within "
                f"{g['rel']:.3e} of its largest logit (tol {MESH_TOL:.0e}); "
                f"greedy agreement with one device "
                f"{g['agree']:.4f}; a rank's weight bytes "
                f"{mem['weight_bytes']} of {wbytes}, state / ring bytes "
                f"{mem['kv_bytes']} of {kvbytes}; decode step median "
                f"{statistics.median(rs[1:]) * 1e3:.2f} ms a rank (one "
                f"device {step * 1e3:.2f}; the card shared with the main "
                f"process); launches a rank "
                f"{ {k: v for k, v in r0['launches'].items() if v} }; {card}")
        log(f"[mesh-d/e] ranks {self.ranks.seconds:.1f} s beside the main "
            f"process (start, init, shard, serve, teacher-force); parts (d) "
            f"and (e) {time.perf_counter() - self.t0:.1f} s from the "
            f"references to the gates ({card})")
        return self.counts


class MeshMoe:
    """17c on phase 14's tree cut to MESH_MOE_LAYERS (full width): one
    device's run on phase 14's requests over the linear cache, then
    ``launch/serve --load-packed --mesh-model 2 --share-cards``'s serving
    run on two ranks sharing the card (the tree saved once), each holding
    half of every layer's experts, started by the constructor and run
    beside the main process.  A single ``torch.bmm`` over 64 experts is
    not the same bits as over 128 at a decode step's capacity
    (``launch/row_probe --batches``), but the MoE multiplies its experts in
    blocks of E / 4, so a rank makes one device's calls: its
    streams and statuses must equal one device's, its teacher-forced
    logits on them lie within MESH_TOL (and no routed row's top-k may
    differ).  Logs a rank's expert count, bytes and one layer's expert
    dequantization against one device's.  ``streams``: one device's
    streams at this depth."""

    def __init__(self, torch, params, card):
        from repro_torch.models.init import layer
        from repro_torch.train import checkpoints
        self.card, self.t0 = card, time.perf_counter()
        self.counts = zero_counts()
        tree = dict(params, layers=_depth(params["layers"], MESH_MOE_LAYERS))
        argv = _with(SERVE_ARGS, arch=MOE_ARCH, layers=MESH_MOE_LAYERS)
        out, c = _counted_serve(argv, tree)
        _add(self.counts, c)
        self.streams = _streams(out)
        self.ref = routed_forced(torch, out["model"], tree, out["prompts"],
                                 self.streams, out["engine"].cfg.max_len)
        self.wbytes = out["weight_bytes"]
        self.step = statistics.median(out["step_seconds"][1:])
        del out
        # one layer's expert dequantization: all E experts, and a rank's
        leaves = [v for k, v in sorted(layer(tree["layers"], 0)["moe"]
                                       .items()) if k != "router"]
        self.e = leaves[0].packed.shape[0]
        half = [qt[:self.e // MESH_MODEL] for qt in leaves]
        if MESH_DEVICE == "cuda":
            timer = Timer(torch)
            self.deq = [timer(lambda ls=ls: [qt.dequantize() for qt in ls],
                              reps=5) for ls in (leaves, half)]
            del timer
        else:
            self.deq = [float("nan")] * 2
        tmp = _mesh_tmp()
        checkpoints.save(str(tmp / "tree"), 0, tree)
        self.ranks = MeshRanks([{
            "tag": "moe", "kind": "serve", "streams": self.streams,
            "argv": argv + MESH_FLAGS + ["--load-packed", str(tmp / "tree")]
        }], tmp)

    def finish(self, torch) -> dict:
        from repro_torch.models.moe import expert_block
        card, e = self.card, self.e
        ranks, saved = self.ranks.finish(torch)
        g = _mesh_gate("moe", ranks, saved["moe"], self.ref, self.streams,
                       self.wbytes, exact=True)
        for rank in ranks:
            r = rank["moe"]
            if r["experts"] != e // MESH_MODEL:
                raise RuntimeError(f"mesh-c: rank {r['rank']} holds "
                                   f"{r['experts']} experts a layer, not "
                                   f"{e // MESH_MODEL}")
            require_launched(r["launches"], ("w4a8_matmul", "flash_prefill",
                                             "flash_decode"),
                             f"mesh-c rank {r['rank']}")
            _add(self.counts, {k: v for k, v in r["launches"].items()
                               if k in self.counts})
            rs = r["step_seconds"]
            log(f"[mesh-c] rank {r['rank']} of (1, {MESH_MODEL}) "
                f"({r['backend']}, two ranks on the card): {r['experts']} of "
                f"{e} experts a layer; weight bytes "
                f"{r['memory']['weight_bytes']} of {self.wbytes} "
                f"({r['memory']['weight_bytes'] / self.wbytes:.3f}), KV "
                f"bytes {r['memory']['kv_bytes']}; decode step median "
                f"{statistics.median(rs[1:]) * 1e3:.2f} ms over "
                f"{len(rs) - 1} steps (one device {self.step * 1e3:.2f}; "
                f"the card shared with the main process); statuses "
                f"{r['statuses']}; launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }; {card}")
        log(f"[mesh-c] {MOE_ARCH} x{MESH_MOE_LAYERS} (depth cut from 48, "
            f"full width) w4a4 g128 kv8, phase 14's requests: every rank's "
            f"streams and statuses equal one device's (experts multiplied "
            f"in blocks of {expert_block(e)}); teacher-forced logits within "
            f"{g['rel']:.3e} of one device's largest logit (tol "
            f"{MESH_TOL:.0e}), routing flips {g['flips']} of {g['routed']} "
            f"routed rows; one layer's expert "
            f"dequantization to float32: all {e} experts {self.deq[0]:.3f} "
            f"ms, a rank's {e // MESH_MODEL} {self.deq[1]:.3f} ms; ranks "
            f"{self.ranks.seconds:.1f} s; part (c) "
            f"{time.perf_counter() - self.t0:.1f} s from one device's run to "
            f"the gates ({card})")
        return self.counts


def device_kernels(torch, fn, want, tries: int = 5) -> tuple[list, int]:
    """The names of the device kernels one call of ``fn`` runs
    (torch.profiler), and how many traces were taken again.  Every traced
    call must return ``want`` bit for bit.  The profiler at times loses a
    trace's device records (``python -m repro_torch.launch.card_probe``
    counts how often): the trace holds no device event while its CPU side
    holds the kernel launch (``cudaLaunchKernel`` /
    ``cudaLaunchKernelExC``), the wrapper counted it and the output is
    bit-equal.  Only such a trace is taken again, up to ``tries`` times;
    an empty trace with no launch call fails."""
    from torch.autograd import DeviceType
    act = torch.profiler.ProfilerActivity
    for retry in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            got = fn()
            torch.cuda.synchronize()
        if not torch.equal(got.reshape(want.shape), want):
            raise RuntimeError("repack: a traced call differs from the "
                               "plain version")
        events = prof.events()
        names = [e.name for e in events if e.device_type == DeviceType.CUDA]
        if names:
            return names, retry
        if not any(re.match(r"cu(da)?LaunchKernel", e.name) for e in events):
            raise RuntimeError("repack: a traced call launched no kernel")
        log("[repack] the profiler lost the device records of a launch; "
            "tracing again")
    raise RuntimeError(f"repack: {tries} traces in a row lost their device "
                       f"records")


def repack(torch, params, prompts) -> tuple[dict, int]:
    """Phase 7 (see the module docstring); returns its launch counts and
    how many profiler traces were taken again."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig, quantize_codes
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.launch import serve
    from repro_torch.models.init import init_block, init_top
    from repro_torch.serve.quantized import PACKED_MLP, PACKED_WEIGHTS
    args = serve.build_parser().parse_args(SERVE_ARGS)
    bits, group = args.wbits, args.group
    qcfg = QuantConfig(w_bits=bits, group_size=group)
    cfg = get_config(args.arch)
    dev = "cuda"
    # launch/serve.py::random_packed_lm's draws, in its order
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init_top(cfg, gen, dev)
    x = params["embed"][prompts.to(dev).long()]            # (4, 128, d)
    acts = (x[:, :1], x)                                   # M = 4 and 512
    layers = params["layers"]
    _lib.reset_launches()
    t0 = time.perf_counter()
    n_linear = n_matmul = 0
    for i in range(LAYERS):
        block = init_block(cfg, gen, dev)
        linears = ([(k, block[k], layers[k]) for k in PACKED_WEIGHTS]
                   + [(k, block["mlp"][k], layers["mlp"][k])
                      for k in PACKED_MLP])
        for name, w, served in linears:
            got = ops.quantize_pack(w, bits=bits, group_size=group)
            qt = served[i]
            plain = quantize_codes(w, qcfg)
            if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                       zip(got, (qt.packed, qt.scale, qt.zp),
                           (plain.packed, plain.scale, plain.zp))):
                raise RuntimeError(f"repack: layer {i} {name} differs from "
                                   f"the served QTensor or quantize_codes")
            n_linear += 1
        for name, w, _ in linears:
            if name not in ("wq", "w_up"):
                continue
            amax = torch.amax(w.abs(), dim=0)
            w_scale = amax / torch.full_like(amax, 127.0)
            w_q = torch.clamp(torch.round(w / w_scale), -128, 127).to(
                torch.int8)
            for xa in acts:
                x2 = xa.reshape(-1, xa.shape[-1])
                want = i8.w8a8_dynamic_plain(x2, w_q, w_scale)
                got = ops.w8a8_matmul(xa, w_q, w_scale)
                x_q, x_scale = i8.act_quant_plain(x2, 8)
                got8 = i8.int8_matmul(x_q.to(torch.int8), x_scale, w_q,
                                      w_scale)
                if not (torch.equal(got.reshape(want.shape), want)
                        and torch.equal(got8, want)):
                    raise RuntimeError(f"repack: w8a8 / int8 on layer {i} "
                                       f"{name} at M={x2.shape[0]} differ "
                                       f"from the plain version")
                n_matmul += 1
                probe = (w_q, w_scale)
        del block, linears
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    log(f"[repack] {n_linear} linears of {LAYERS} layers repacked w{bits} "
        f"g{group} by quantize_pack, equal to the served tree (packed at "
        f"startup by the same kernel) and to the plain quantize_codes "
        f"(packed, scale, zp); {n_matmul} w8a8_matmul + int8_matmul products on the "
        f"prompts' embeddings bit-equal to the plain version; "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    if counts["quantize_pack"] != n_linear:
        raise RuntimeError(f"repack: {counts['quantize_pack']} quantize_pack "
                           f"launches for {n_linear} linears")
    for name in ("w8a8_matmul", "int8_matmul"):
        if counts[name] <= 0:
            raise RuntimeError(f"repack: {name} was never launched")
    # device kernels of one call of each entry, after the counts are read
    w_q, w_scale = probe
    retries = 0
    for xa in acts:
        x2 = xa.reshape(-1, xa.shape[-1])
        plain = i8.w8a8_dynamic_plain(x2, w_q, w_scale)
        x_q, x_scale = i8.act_quant_plain(x2, 8)
        x_q = x_q.to(torch.int8)
        for name, fn, want in (
                ("w8a8_matmul", lambda: ops.w8a8_matmul(xa, w_q, w_scale), 2),
                ("int8_matmul",
                 lambda: i8.int8_matmul(x_q, x_scale, w_q, w_scale), 1)):
            names, n = device_kernels(torch, fn, plain)
            retries += n
            ours = [re.search(r"\w+_kernel", k).group(0) for k in names
                    if re.search(r"int8_\w+_kernel|act_quant_kernel", k)]
            log(f"[repack] {name} at M={x_q.shape[0]}: {len(ours)} launch(es) "
                f"a call ({', '.join(ours)}); other device work: "
                f"{len(names) - len(ours)} kernel(s)")
            if len(ours) != want:
                raise RuntimeError(f"repack: {name} launched {len(ours)} "
                                   f"kernels a call, not {want}")
    del x, acts
    torch.cuda.empty_cache()
    return counts, retries


# ---------------------------------------------------------------------------
# 8. calibrate llama-7b-width blocks on the card and serve what they pack
# ---------------------------------------------------------------------------

CALIB_LAYERS = 2          # llama-7b depth cut from 32: calibration's time
CALIB_ARGS = ["--arch", "llama-7b", "--layers", str(CALIB_LAYERS),
              "--method", "affine", "--epochs", "3", "--alpha", "0.1",
              "--calib-samples", "32", "--calib-seq", "512", "--seed", "0",
              "--device", "cuda"]
CALIB_RUNS = {"a": dict(wbits=4, abits=4, group=128, kvbits=8),
              "b": dict(wbits=4, abits=16, group=128, kvbits=16)}
# (b): the packed tree through the kernels against the fake-quant tree
# through the float forward differ only by float reassociation ((h @ inv(A))
# @ Q(A W) against h @ (inv(A) @ Q(A W))) and summation order; on the CPU
# (plain versions, 3 epochs) the largest logit difference was 1.7e-6
# (llama-mini) and 1.4e-6 (d 1024) of the largest logit.
FAKE_TOL = 1e-4


def require_launched(counts: dict, names, tag: str) -> None:
    for name in names:
        if counts[name] <= 0:
            raise RuntimeError(f"{tag}: {name} was never launched")


def _counted_serve(argv: list, params):
    """One serving run through the CLI's entry point, launch counters zeroed
    just before and read just after."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    _lib.reset_launches()
    out = serve.serve(serve.build_parser().parse_args(argv), params)
    return out, dict(_lib.LAUNCHES)


def _margins(torch, out) -> dict:
    """Dominance margin of every full and headwise effective matrix after
    the last epoch (a headwise site: its least margin over the heads)."""
    from repro_torch.core import affine as af
    from repro_torch.core import calibration as cal
    from repro_torch.core import gradual_mask as gm
    ccfg, margins = out["ccfg"], {}
    for i, qp in enumerate(out["info"]["block_qps"]):
        specs = cal._specs_from(qp)
        masks = cal._masks(specs, ccfg.epochs, ccfg, out["model"].device)
        for name, spec in specs.items():
            if spec.kind != "diagonal":
                a = af.effective_matrix(spec, qp["affine"][name], masks[name])
                margins[f"block {i} {name} {spec.kind} "
                        f"{'x'.join(map(str, a.shape))}"] = \
                    float(gm.dominance_margin(a))
    return margins


def calibrate_run(torch, tag, calib_argv, serve_argv, flags, counts,
                  params=None) -> dict:
    """Calibrate once through ``launch/calibrate.py`` with ``flags``
    (wbits, abits, group, kvbits), gate the epoch losses and dominance
    margins, round-trip the packed tree through ``checkpoints.save`` /
    ``load_tree``, serve it from memory and with ``--load-packed`` (streams
    equal, launches added to ``counts``) and hold the kernel path against
    the plain versions (a4: the per-block check; a16: end to end, and the
    packed tree against the fake-quant tree within FAKE_TOL).  Returns the
    float and packed trees, the report and the in-memory serving run."""
    import tempfile
    import numpy as np
    from repro_torch.launch import calibrate, serve
    from repro_torch.train import checkpoints
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = calibrate.calibrate(calibrate.build_parser().parse_args(
        _with(calib_argv, wbits=flags["wbits"], abits=flags["abits"],
              group=flags["group"])), params)
    info, rep = out["info"], out["report"]
    steps = info["step_seconds"]
    kinds = {n: d["kind"] for n, d in info["block_qps"][0]["_sites"].items()}
    log(f"[{tag}] {out['cfg'].name} x{out['cfg'].num_layers} "
        f"w{flags['wbits']}a{flags['abits']}g{flags['group']} sites {kinds}: "
        f"{len(steps)} steps, median {statistics.median(steps):.4f} s a "
        f"step (min {min(steps):.4f}, max {max(steps):.4f}); calibration "
        f"and finalize {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{tag}] epoch losses per block {info['block_losses']}; held-out "
        f"16 x 512 perplexity fp {rep['fp_ppl']:.4f} -> quant "
        f"{rep['quant_ppl']:.4f} (random weights: informative only)")
    margins = _margins(torch, out)
    log(f"[{tag}] dominance margins (Levy-Desplanques, > 0 = "
        f"invertible): {margins}")
    for i, losses in enumerate(info["block_losses"]):
        if not (len(losses) == out["ccfg"].epochs
                and all(map(math.isfinite, losses))
                and losses[-1] < losses[0]):
            raise RuntimeError(f"{tag}: block {i} losses {losses} are not "
                               f"finite and falling")
    if not (margins and min(margins.values()) > 0):
        raise RuntimeError(f"{tag}: an effective matrix is not strictly "
                           f"diagonally dominant")
    packed, fake, cfg, qcfg = (out[k] for k in ("packed", "fake", "cfg",
                                               "qcfg"))
    params, dev = out["params"], out["model"].device
    del out
    sargv = _with(serve_argv, device=dev.type, **flags)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        checkpoints.save(ckpt, 0, packed)
        t_saved = time.perf_counter()
        back = checkpoints.load_tree(ckpt, cfg, qcfg, device=dev)
        t_read = time.perf_counter()
        n, nbytes, same = _byte_equal(torch, packed, back)
        log(f"[{tag}] packed tree saved in {t_saved - t0:.1f} s, read back "
            f"in {t_read - t_saved:.1f} s: {n} leaves, {nbytes} bytes, "
            f"byte-equal {same}")
        if not same:
            raise RuntimeError(f"{tag}: the checkpoint round trip changed "
                               f"the packed tree")
        del back
        mem, c_mem = _counted_serve(sargv, packed)
        disk, c_disk = _counted_serve(sargv + ["--load-packed", ckpt], None)
    streams = [r.out_tokens for r in mem["requests"]]
    steps = mem["step_seconds"]
    log(f"[{tag}] served {mem['generated']} + {disk['generated']} tokens "
        f"(in memory, --load-packed) at {mem['tokens_per_s']:.2f} / "
        f"{disk['tokens_per_s']:.2f} tok/s; decode step median "
        f"{statistics.median(steps[1:]) * 1e3:.2f} ms (in memory); launches "
        f"{c_mem} / {c_disk}")
    if any(len(s) != 32 for s in streams):
        raise RuntimeError(f"{tag}: a request did not produce 32 tokens")
    if [r.out_tokens for r in disk["requests"]] != streams:
        raise RuntimeError(f"{tag}: --load-packed streams differ from the "
                           f"in-memory tree's")
    log(f"[{tag}] --load-packed greedy streams equal the in-memory tree's")
    main = ("w4a8_matmul",) if flags["abits"] < 16 else ("dequant_matmul",)
    for c in (c_mem, c_disk):
        require_launched(c, main + ("flash_prefill", "flash_decode"), tag)
        _add(counts, c)
    del disk
    prompts = torch.from_numpy(np.stack(mem["prompts"]))
    gen = torch.tensor(streams, dtype=torch.int32)
    if flags["abits"] < 16:
        gate_blockwise(torch, tag, mem, prompts, gen)
    else:
        a16_gate(torch, tag, mem, prompts, gen)
        lp, ls = serve.packed_and_fake_logits(mem["model"], packed, fake,
                                             mem["prompts"], streams)
        rel = ((lp - ls).abs().max() / ls.abs().max()).item()
        agree = (lp.argmax(-1) == ls.argmax(-1)).float().mean().item()
        log(f"[{tag}] packed tree (kernels) vs fake-quant tree (float "
            f"forward), teacher-forced over 4 x 32 tokens: max|dlogit| / "
            f"max|logit| {rel:.3e} (tol {FAKE_TOL:.0e}); greedy agreement "
            f"{agree:.4f}")
        if not (torch.isfinite(lp).all() and rel <= FAKE_TOL):
            raise RuntimeError(f"{tag}: the packed tree departs from the "
                               f"calibrated simulation")
        del lp, ls
    del fake
    return {"params": params, "packed": packed, "report": rep, "mem": mem,
            "streams": streams}


def _byte_equal(torch, a, b) -> tuple:
    """(leaves, bytes, equal) of two trees compared on their device: the
    same leaves (a QTensor's codes, scale and zero points each), dtypes,
    shapes and bytes."""
    from repro_torch.core.qtensor import QTensor

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, QTensor):
            for f in ("packed", "scale", "zp"):
                yield path + (f,), getattr(tree, f)
        else:
            yield path, tree

    la, lb = dict(leaves(a)), dict(leaves(b))

    def same(x, y):
        if not isinstance(x, torch.Tensor):
            return x == y
        return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and x.shape == y.shape and torch.equal(
                    x.reshape(-1).view(torch.uint8),
                    y.to(x.device).reshape(-1).view(torch.uint8)))
    equal = la.keys() == lb.keys() and all(same(la[k], lb[k]) for k in la)
    nbytes = sum(t.numel() * t.element_size() for t in la.values()
                 if isinstance(t, torch.Tensor))
    return len(la), nbytes, equal


def a16_gate(torch, tag, out, prompts, gen) -> None:
    """Teacher-forced logits (prefill + 8 decode steps) of the a16 path,
    kernels against plain versions, within A16_TOL."""
    a, p = teacher_forced_logits(torch, out, prompts, gen)
    rel = ((a - p).abs().max() / p.abs().max()).item()
    log(f"[{tag}] teacher-forced logits (prefill + 8 decode steps), "
        f"kernels vs plain: max|dlogit| / max|logit| {rel:.3e} (tol "
        f"{A16_TOL:.0e})")
    if not (torch.isfinite(a).all() and rel <= A16_TOL):
        raise RuntimeError(f"{tag}: kernels and plain versions disagree")


def calibrate_phase(torch, ppl: dict) -> dict:
    """Phase 8 (see the module docstring); returns its launch counts and
    records each run's perplexities in ``ppl``."""
    t_phase = time.perf_counter()
    log(f"[calibrate] llama-7b widths, depth cut to {CALIB_LAYERS} of 32 "
        f"layers; 32 x 512 calibration tokens (the paper: 128 x 2048), batch "
        f"8, 3 epochs, alpha 0.1; float32, no TF32")
    counts = zero_counts()
    params = None
    for run, flags in CALIB_RUNS.items():
        out = calibrate_run(torch, f"calibrate-{run}", CALIB_ARGS,
                            _with(SERVE_ARGS, layers=CALIB_LAYERS), flags,
                            counts, params)
        params = out["params"]
        rep = out["report"]
        ppl.setdefault("llama-7b", {"fp": rep["fp_ppl"]})[
            f"affine w4a{flags['abits']}"] = rep["quant_ppl"]
        del out
    del params
    torch.cuda.empty_cache()
    log(f"[calibrate] phase wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# 10. opt-125m at full width and depth: AffineQuant calibration and serving,
#     and the RTN / AWQ / GPTQ baselines
# ---------------------------------------------------------------------------

OPT_SERVE_ARGS = _with(SERVE_ARGS, arch="opt-125m")
OPT_CALIB_ARGS = _with(CALIB_ARGS, arch="opt-125m", layers=0)   # all 12
OPT_POOL_PAGES = 10       # 4 x (128 + 32 + 1) positions need 12 pages of 64
BASELINES = ("rtn", "awq", "gptq")


def opt_phase(torch, ppl: dict) -> dict:
    """Phase 10 (see the module docstring); returns its launch counts."""
    t_phase = time.perf_counter()
    card = card_name(torch)
    log(f"[opt] opt-125m at full width and depth (12 layers, d 768, 12 "
        f"heads of 64, d_ff 3072, vocab 50272), random seeded weights; "
        f"calibration as phase 8 (32 x 512 tokens, batch 8, 3 epochs, alpha "
        f"0.1); {card}")
    counts = zero_counts()
    ppl["opt-125m"] = {}
    # (a) W4A4 g128: diagonal LayerNorm sites (shifts into the norms' and
    # the q/k/v / fc1 biases) and 12 headwise vo sites; linear kv8, then the
    # preempting pool of pages and chunks of 64, then kv4
    t0 = time.perf_counter()
    a = calibrate_run(torch, "opt-a", OPT_CALIB_ARGS, OPT_SERVE_ARGS,
                      CALIB_RUNS["a"], counts)
    params = a["params"]
    streams_a = a["streams"]
    ppl["opt-125m"].update(fp=a["report"]["fp_ppl"],
                           **{"affine w4a4": a["report"]["quant_ppl"]})
    base = _with(OPT_SERVE_ARGS, **CALIB_RUNS["a"])
    out, c = _serve_paged_run(torch, "opt-paged", a["packed"], base=base,
                              page_size=64, prefill_chunk=64,
                              num_pages=OPT_POOL_PAGES)
    if out["preemptions"] < 1:
        raise RuntimeError("opt-paged: the 10-page pool never preempted")
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     "opt-paged")
    if [r.out_tokens for r in out["requests"]] != a["streams"]:
        raise RuntimeError("opt-paged: the preempting pool's streams differ "
                           "from the linear cache's")
    log("[opt-paged] greedy streams equal the linear kv8 streams token for "
        "token, through preemption and chunked resume")
    _gate_served(torch, "opt-paged", out, page_size=64, chunk=64)
    _add(counts, c)
    del out
    out, c = _serve_paged_run(torch, "opt-kv4", a["packed"], base=base,
                              kvbits=4, page_size=64, prefill_chunk=64)
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     "opt-kv4")
    _gate_served(torch, "opt-kv4", out, page_size=64, chunk=64)
    _add(counts, c)
    del out, a
    log(f"[opt] (a) {time.perf_counter() - t0:.1f} s")
    # (b) W4A16 g128: full 768 x 768 sites under the gradual mask
    t0 = time.perf_counter()
    b = calibrate_run(torch, "opt-b", OPT_CALIB_ARGS, OPT_SERVE_ARGS,
                      CALIB_RUNS["b"], counts, params)
    ppl["opt-125m"]["affine w4a16"] = b["report"]["quant_ppl"]
    del b
    log(f"[opt] (b) {time.perf_counter() - t0:.1f} s")
    # (d) the float tree itself through the float Model
    t0 = time.perf_counter()
    _add(counts, serve_float(torch, "fp-opt", OPT_SERVE_ARGS, params,
                             streams_a, pool_pages=OPT_POOL_PAGES))
    log(f"[opt] (d) {time.perf_counter() - t0:.1f} s")
    # (c) the baselines, on opt-125m and on phase 8's llama-7b-width blocks
    t0 = time.perf_counter()
    baselines(torch, "opt-125m", OPT_CALIB_ARGS, OPT_SERVE_ARGS, counts,
              ppl, params)
    del params
    baselines(torch, "llama-7b", CALIB_ARGS,
              _with(SERVE_ARGS, layers=CALIB_LAYERS), counts, ppl)
    log(f"[opt] (c) {time.perf_counter() - t0:.1f} s")
    for arch, row in ppl.items():
        log(f"[opt] held-out 16 x 512 perplexity, {arch} (random weights, "
            f"w4 g128): " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    torch.cuda.empty_cache()
    log(f"[opt] phase 10 wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}; {card}")
    return counts


def _add(counts: dict, c: dict) -> None:
    for name in COUNTED:
        counts[name] += c[name]


def _gate_served(torch, tag, out, **paged) -> None:
    """The per-block teacher-forced check on a serving run's streams."""
    import numpy as np
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in out["requests"]],
                       dtype=torch.int32)
    gate_blockwise(torch, tag, out, prompts, gen, **paged)


def baselines(torch, arch, calib_argv, serve_argv, counts, ppl,
              params=None) -> None:
    """(c) on one arch: RTN, AWQ and GPTQ at W4A16 g128 through
    ``launch/calibrate.py``.  Gates: finite perplexities; AWQ's layer-output
    MSE on each linear's calibration inputs at most RTN's (alpha 0 is
    RTN); GPTQ's summed over each block below RTN's; RTN's packed tree
    (``quantize_pack``, one launch a linear's stack of layers) byte-equal to
    ``quantize_codes`` and dequantizing bit for bit to the fake-quant RTN
    tree, then served through dequant_matmul and held end to end against
    the plain versions."""
    import numpy as np
    from repro_torch.core.baselines import DENSE_LINEARS
    from repro_torch.core.calibration import _get
    from repro_torch.core.quantizer import quantize_codes
    from repro_torch.launch import calibrate
    from repro_torch.models.layers import GATED
    flags = dict(wbits=4, abits=16, group=128)
    row = ppl.setdefault(arch, {})
    for method in BASELINES:
        tag = f"{arch}-{method}"
        c = zero_counts()
        with counted(c):
            out = calibrate.calibrate(calibrate.build_parser().parse_args(
                _with(calib_argv, method=method, **flags)), params)
            torch.cuda.synchronize()
        params, rep, info = out["params"], out["report"], out["info"]
        row.setdefault("fp", rep["fp_ppl"])
        row[method] = rep["quant_ppl"]
        secs = rep["block_seconds"]
        log(f"[{tag}] w4a16g128 x{out['cfg'].num_layers}: perplexity fp "
            f"{rep['fp_ppl']:.4f} -> {rep['quant_ppl']:.4f}; seconds per "
            f"block {[round(x, 3) for x in secs]} (median "
            f"{statistics.median(secs):.3f}); launches {c}")
        if not all(map(math.isfinite, (rep["fp_ppl"], rep["quant_ppl"]))):
            raise RuntimeError(f"{tag}: a perplexity is not finite")
        lin = [k for k, _ in DENSE_LINEARS
               if k != "mlp/w_gate" or out["cfg"].act in GATED]
        moved = max(float((_get(out["fake"]["layers"], k)
                           - _get(params["layers"], k))
                          .abs().max()) for k in lin)
        log(f"[{tag}] largest change of a weight, fake-quant tree vs float: "
            f"{moved:.4e} (the float32 loss resolves the perplexity to "
            f"~{rep['fp_ppl'] * 2 ** -20:.3f})")
        if method == "awq":
            worse = [(i, k) for i, blk in enumerate(info["linear_mse"])
                     for k, (m, r) in blk.items() if not m <= r]
            ratio = [max(m / r for m, r in blk.values())
                     for blk in info["linear_mse"]]
            log(f"[{tag}] layer-output MSE against RTN's on each linear's "
                f"calibration inputs: largest ratio per block "
                f"{[round(x, 4) for x in ratio]}")
            if worse:
                raise RuntimeError(f"{tag}: AWQ loses to RTN on {worse}")
        elif method == "gptq":
            sums = [(sum(m for m, _ in blk.values()),
                     sum(r for _, r in blk.values()))
                     for blk in info["linear_mse"]]
            log(f"[{tag}] layer-output MSE summed over each block, GPTQ / "
                f"RTN: {[f'{m:.4e} / {r:.4e}' for m, r in sums]}")
            if not all(m < r for m, r in sums):
                raise RuntimeError(f"{tag}: GPTQ does not beat RTN in every "
                                   f"block")
        else:
            _rtn_packed(torch, tag, out, lin, c, quantize_codes)
            mem, cs = _counted_serve(_with(serve_argv, arch=arch,
                                           kvbits=16, **flags),
                                     out["packed"])
            require_launched(cs, ("dequant_matmul", "flash_prefill",
                                  "flash_decode"), tag)
            _add(c, cs)
            prompts = torch.from_numpy(np.stack(mem["prompts"]))
            gen = torch.tensor([r.out_tokens for r in mem["requests"]],
                               dtype=torch.int32)
            a16_gate(torch, tag, mem, prompts, gen)
            del mem
        _add(counts, c)
        del out
        torch.cuda.empty_cache()


def _rtn_packed(torch, tag, out, lin, c, quantize_codes) -> None:
    """RTN's packed tree: one quantize_pack launch a linear's stack over
    the layers, the bytes of ``quantize_codes``, dequantized equal to the
    fake-quant tree."""
    from repro_torch.core.calibration import _get
    cfg, qcfg = out["cfg"], out["qcfg"]
    if c["quantize_pack"] != len(lin):
        raise RuntimeError(f"{tag}: {c['quantize_pack']} quantize_pack "
                           f"launches, not one per stacked linear")
    for k in lin:
        qt, w, fq = (_get(out[t]["layers"], k)
                     for t in ("packed", "params", "fake"))
        plain = quantize_codes(w, qcfg)
        if not all(torch.equal(getattr(qt, f), getattr(plain, f))
                   for f in ("packed", "scale", "zp")):
            raise RuntimeError(f"{tag}: {k} packed by quantize_pack differs "
                               f"from quantize_codes")
        if not torch.equal(qt.dequantize(), fq):
            raise RuntimeError(f"{tag}: {k} does not dequantize to the "
                               f"fake-quant RTN weight")
    log(f"[{tag}] packed tree: {len(lin)} x {cfg.num_layers} linears "
        f"through quantize_pack, byte-equal to quantize_codes, dequantized "
        f"bit for bit to the fake-quant tree")


# ---------------------------------------------------------------------------
# 11. the float model: llama-7b at its published width and depth (and the
#     same runs for opt-125m in phase 10 and gemma-2b in phase 12)
# ---------------------------------------------------------------------------

# Float kernels vs plain versions, and the chunked / preempted streams'
# logits contract: the float paths differ only by float32 summation order
# (attention's, and ``torch.matmul``'s at other row counts), which 32
# random layers amplify; on the CPU (2 layers) the same differences stay
# below 1e-6 of the largest logit.
FLOAT_TOL = 1e-4
POOL_PAGES = 10           # phase 5b's pool: 4 x (128 + 32 + 1) need 12


def _streams(out) -> list:
    return [list(r.out_tokens) for r in out["requests"]]


def _float_run(torch, tag, argv, params, counts, **flags):
    """One float serving run through the CLI's entry point (``--fp``),
    launch counters zeroed just before and added to ``counts`` just after;
    every request must complete with max_new tokens."""
    out, c = _counted_serve(_with(argv, fp=True, **flags), params)
    steps = out["step_seconds"]
    kv = out["engine"]._kv
    pool = (f"{kv.allocator.num_pages} pages of {flags['page_size']}"
            if flags.get("paged") else "linear")
    log(f"[{tag}] {out['cfg'].name} x{out['cfg'].num_layers} fp, {pool}, "
        f"prefill chunk {flags.get('prefill_chunk') or 'whole prompt'}: "
        f"{out['generated']} tokens in {out['seconds']:.3f} s = "
        f"{out['tokens_per_s']:.2f} tok/s; first step {steps[0]:.4f} s, "
        f"decode step median {statistics.median(steps[1:]) * 1e3:.2f} ms "
        f"over {len(steps) - 1} steps; preemptions {out['preemptions']}; "
        f"weight bytes {out['weight_bytes']}, KV bytes {out['kv_bytes']}; "
        f"launches {c}")
    n_new = int(argv[argv.index("--max-new") + 1])
    bad = [r.rid for r in out["requests"] if r.status.name != "COMPLETED"
           or len(r.out_tokens) != n_new]
    if bad:
        raise RuntimeError(f"{tag}: requests {bad} did not complete with "
                           f"{n_new} tokens")
    # whole prompts prefill into a linear cache and splice into the pages;
    # chunks prefill into the pages
    names = (("flash_prefill_paged" if flags.get("prefill_chunk")
              else "flash_prefill"),
             "flash_decode_paged" if flags.get("paged") else "flash_decode")
    require_launched(c, names, tag)
    if c["w4a8_matmul"] or c["dequant_matmul"]:
        raise RuntimeError(f"{tag}: a packed matmul ran on the float path")
    if flags.get("paged"):
        kv.verify()
        if kv.allocator.num_free != kv.allocator.num_pages:
            raise RuntimeError(f"{tag}: pages leaked")
    _add(counts, c)
    return out


def float_contract(torch, tag, out, base: list, chunk: int = 64) -> None:
    """The chunked / preempted float streams' contract: teacher-forced on
    the stream, the prompt prefilled in chunks gives logits within
    FLOAT_TOL of the whole prompt's at every served position, and every
    served token is the whole-prompt path's greedy choice or ties it
    within FLOAT_TOL; the greedy agreement with the linear streams is
    logged beside it."""
    import numpy as np
    from repro_torch.launch.serve import agreement, near_greedy, teacher_forced
    streams = _streams(out)
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor(streams, dtype=torch.int32)
    n, max_len = gen.shape[1], 512
    whole = teacher_forced(out["model"], out["params"], prompts, gen, n - 1,
                           max_len)
    chunked = teacher_forced(out["model"], out["params"], prompts, gen,
                             n - 1, max_len, chunk=chunk)
    rel = ((chunked - whole).abs().max() / whole.abs().max()).item()
    near = near_greedy(whole, gen, FLOAT_TOL)
    log(f"[{tag}] teacher-forced on its {gen.numel()} served tokens: "
        f"chunked (chunks of {chunk}) vs whole-prompt logits max|dlogit| / "
        f"max|logit| {rel:.3e} (tol {FLOAT_TOL:.0e}); served tokens within "
        f"tol of the whole path's greedy choice {near:.4f} (gate 1.0); "
        f"greedy agreement with the linear streams "
        f"{agreement(base, streams):.4f} (reported)")
    if not (torch.isfinite(whole).all() and rel <= FLOAT_TOL and near == 1.0):
        raise RuntimeError(f"{tag}: the float stream breaks the logits "
                           f"contract")


def float_kernels_vs_plain(torch, tag, out, steps: int = 8) -> None:
    """Teacher-forced logits (prefill + ``steps`` decode steps) through the
    kv16 attention kernels against the plain versions, within FLOAT_TOL."""
    import numpy as np
    from repro_torch.launch.serve import teacher_forced
    from repro_torch.models.model import Model
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor(_streams(out), dtype=torch.int32)
    a, p = (teacher_forced(Model(out["cfg"], out["model"].device, mode),
                           out["params"], prompts, gen, steps, 512)
            for mode in ("auto", "plain"))
    rel = ((a - p).abs().max() / p.abs().max()).item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    log(f"[{tag}] teacher-forced logits (prefill + {steps} decode steps), "
        f"kernels vs plain: max|dlogit| / max|logit| {rel:.3e} (tol "
        f"{FLOAT_TOL:.0e}); greedy agreement {agree:.4f}")
    if not (torch.isfinite(a).all() and rel <= FLOAT_TOL):
        raise RuntimeError(f"{tag}: float kernels and plain versions "
                           f"disagree")


def serve_float(torch, tag, argv, params, packed_streams=None,
                pool_pages: int = POOL_PAGES, chunked: bool = True) -> dict:
    """A float tree through the float Model: linear, pages of 64 (streams
    equal the linear ones), and with ``chunked`` chunks of 64 and a
    ``pool_pages`` pool of 64-token pages that must preempt (the logits
    contract); kernels vs plain.  Logs the greedy agreement with
    ``packed_streams``.  Returns the launch counts."""
    from repro_torch.launch.serve import agreement
    t0 = time.perf_counter()
    counts = zero_counts()
    lin = _float_run(torch, tag, argv, params, counts)
    base = _streams(lin)
    if packed_streams is not None:
        log(f"[{tag}] greedy agreement fp vs the W4A4 g128 kv8 tree made "
            f"from the same floats: {agreement(base, packed_streams):.4f} "
            f"(random weights: reported, not gated)")
    float_kernels_vs_plain(torch, tag, lin)
    params = lin["params"]
    del lin
    paged = _float_run(torch, f"{tag}-paged", argv, params, counts,
                       paged=True, page_size=64)
    if _streams(paged) != base:
        raise RuntimeError(f"{tag}-paged: the paged float streams differ "
                           f"from the linear ones")
    log(f"[{tag}-paged] greedy streams equal the linear streams token for "
        f"token")
    del paged
    if chunked:
        out = _float_run(torch, f"{tag}-chunked", argv, params, counts,
                         paged=True, page_size=64, prefill_chunk=64)
        float_contract(torch, f"{tag}-chunked", out, base)
        del out
        out = _float_run(torch, f"{tag}-pool", argv, params, counts,
                         paged=True, page_size=64, prefill_chunk=64,
                         num_pages=pool_pages)
        if out["preemptions"] < 1:
            raise RuntimeError(f"{tag}-pool: the {pool_pages}-page pool "
                               f"never preempted")
        float_contract(torch, f"{tag}-pool", out, base)
        del out
    torch.cuda.empty_cache()
    log(f"[{tag}] float serving wall time {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    return counts


def float_llama_phase(torch, packed_streams) -> dict:
    """Phase 11 (see the module docstring); returns its launch counts."""
    from repro_torch.launch import row_probe, serve
    t_phase = time.perf_counter()
    card = card_name(torch)
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        res = row_probe.probe(k, n, torch.device("cuda"))
        log(f"[fp-llama] row probe K={k} N={n}, 512 rows vs pieces: " +
            "; ".join(f"{p}: {c} rows differ (max {r:.3e})"
                      for p, (c, r) in res.items()))
    argv = _with(SERVE_ARGS, layers=LAYERS)
    t0 = time.perf_counter()
    params = serve.build_model(serve.build_parser().parse_args(
        _with(argv, fp=True)))[2]
    torch.cuda.synchronize()
    log(f"[fp-llama] random init of the float llama-7b x{LAYERS} tree "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (26.43 GB "
        f"of float32 weights; a decode step must read them: 7.89 ms at "
        f"3.35 TB/s, W4A4's 1.24 ms); {card}")
    counts = serve_float(torch, "fp-llama", argv, params, packed_streams)
    del params
    torch.cuda.empty_cache()
    log(f"[fp-llama] phase 11 wall time {time.perf_counter() - t_phase:.1f} "
        f"s; {card}")
    return counts


# ---------------------------------------------------------------------------
# 12. the dense registry at published widths, and W3A16
# ---------------------------------------------------------------------------

# depth served per arch (the published depth; cut only where time or
# memory force it, and logged)
REGISTRY = {"phi4-mini-3.8b": 32, "qwen2.5-14b": 48, "stablelm-12b": 40,
            "gemma-2b": 18}
W3_LAYERS = 8             # llama-7b depth cut: w3 runs the plain dequant
FLOAT_ARCH = "gemma-2b"   # also served float at full width and depth


def registry_phase(torch) -> dict:
    """Phase 12 (see the module docstring); returns its launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    for arch, layers in REGISTRY.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers != cfg.num_layers:
            log(f"[{arch}] depth cut to {layers} of {cfg.num_layers} layers")
        argv = _with(SERVE_ARGS, arch=arch, layers=layers)
        with counted(counts):
            params = serve.build_model(serve.build_parser().parse_args(
                argv))[2]
            torch.cuda.synchronize()
        log(f"[{arch}] d {cfg.d_model}, {cfg.num_heads} heads / "
            f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.act} {cfg.norm}, "
            f"{'untied' if not cfg.tie_embeddings else 'tied'} head: init + "
            f"RTN packing {time.perf_counter() - t0:.1f} s")
        out, c = _counted_serve(argv, params)
        steps = out["step_seconds"]
        log(f"[{arch}] x{layers} w4a4 g128 kv8: {out['generated']} tokens in "
            f"{out['seconds']:.3f} s = {out['tokens_per_s']:.2f} tok/s; "
            f"decode step median {statistics.median(steps[1:]) * 1e3:.2f} ms; "
            f"weight bytes {out['weight_bytes']}; launches {c}")
        require_launched(c, ("w4a8_matmul", "flash_prefill", "flash_decode"),
                         arch)
        if any(len(s) != 32 for s in _streams(out)):
            raise RuntimeError(f"{arch}: a request did not produce 32 tokens")
        _add(counts, c)
        paged, c = _serve_paged_run(torch, f"{arch}-paged", params,
                                    base=argv, page_size=64)
        if _streams(paged) != _streams(out):
            raise RuntimeError(f"{arch}-paged: the paged streams differ from "
                               f"the linear ones")
        log(f"[{arch}-paged] greedy streams equal the linear streams token "
            f"for token")
        _add(counts, c)
        del paged
        _gate_served(torch, arch, out)
        del out, params
        torch.cuda.empty_cache()
        log(f"[{arch}] wall time {time.perf_counter() - t0:.1f} s")
    # gemma-2b float at full width and depth
    argv = _with(SERVE_ARGS, arch=FLOAT_ARCH, layers=0)
    params = serve.build_model(serve.build_parser().parse_args(
        _with(argv, fp=True)))[2]
    _add(counts, serve_float(torch, "fp-gemma", argv, params, chunked=False))
    del params
    torch.cuda.empty_cache()
    # W3A16 g128: the plain dequant by design
    t0 = time.perf_counter()
    argv = _with(SERVE_ARGS, wbits=3, abits=16, kvbits=16, layers=W3_LAYERS)
    out, c = _counted_serve(argv, None)
    log(f"[w3] llama-7b x{W3_LAYERS} (depth cut) w3a16 g128 kv16: "
        f"{out['generated']} tokens in {out['seconds']:.3f} s = "
        f"{out['tokens_per_s']:.2f} tok/s; decode step median "
        f"{statistics.median(out['step_seconds'][1:]) * 1e3:.2f} ms; "
        f"weight bytes "
        f"{out['weight_bytes']}; launches {c} (the matmuls plain by design: "
        f"no w3 kernel, as in the reference)")
    if c["dequant_matmul"] or c["w4a8_matmul"] or c["quantize_pack"]:
        raise RuntimeError("w3: a packed-matmul or packing kernel ran on "
                           "the w3 path")
    require_launched(c, ("flash_prefill", "flash_decode"), "w3")
    if any(len(s) != 32 for s in _streams(out)):
        raise RuntimeError("w3: a request did not produce 32 tokens")
    _add(counts, c)
    import numpy as np
    a16_gate(torch, "w3", out, torch.from_numpy(np.stack(out["prompts"])),
             torch.tensor(_streams(out), dtype=torch.int32))
    del out
    torch.cuda.empty_cache()
    log(f"[registry] phase 12 wall time {time.perf_counter() - t_phase:.1f} "
        f"s; launches {counts}; {card}")
    return counts


# ---------------------------------------------------------------------------
# 13. training: opt-125m at published width and depth through
#     launch/train (with a kill and resume), the llama-7b width at depth 2,
#     and trained miniatures through the paper's methods, then served
# ---------------------------------------------------------------------------

TRAIN_DEVICE = "cuda"     # "cpu" rehearses the phase with micro sizes
TRAIN_ARGS = ["--arch", "opt-125m", "--steps", "200", "--global-batch", "16",
              "--seq", "128", "--ckpt-every", "100", "--seed", "0",
              "--device", TRAIN_DEVICE]
# llama-7b depth cut from 32: float32 params, gradients and two moments are
# 16 B a parameter (108 GB at 6.74 B parameters), over one 80 GB card
TRAIN_LLAMA = ("llama-7b", 2)
TRAIN_LLAMA_STEPS = 10
# a resumed run against an uninterrupted one, and one step in two
# microbatches or under remat against one plain step: float32 sums in
# another order (the embedding's backward accumulates with atomics), each
# leaf within this share of its largest magnitude
TRAIN_TOL = 1e-5
# benchmarks/common.py::trained_model and table1 / table3's budget
MINI_ARCHS = ("llama-mini", "opt-mini")
MINI_STEPS = 800
MINI_EPOCHS = 8
MINI_CALIB = (16, 96)     # calibration samples x tokens (seed 777)
MINI_TEST = (32, 96)      # held-out samples x tokens (seed 999)


def train_bound_ms(params: int, tokens: int) -> float:
    """6 x params x tokens of float32 work over the card's float32 peak."""
    return 6 * params * tokens / FP32_OPS_PER_S * 1e3


def _named(tree, path: str = "") -> dict:
    """{checkpoint key: tensor} of a TrainState or dict tree, on its
    device."""
    from repro_torch.train.step import TrainState
    if isinstance(tree, TrainState):
        tree = {"0": tree.params, "1": tree.opt, "2": tree.step}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _named(tree[key], f"{path}||{key}" if path
                                   else key).items()}
    return {path: tree}


def _leaves_close(torch, tag, got: dict, want: dict, tol: float) -> int:
    """Every leaf of ``got`` within ``tol`` of the largest magnitude of the
    same leaf of ``want`` (tensors by checkpoint key); returns how many
    leaves are bit-equal."""
    if sorted(got) != sorted(want):
        raise RuntimeError(f"{tag}: the two trees have other leaves")
    same, worst = 0, (0.0, "")
    for k, w in want.items():
        g = got[k]
        if torch.equal(g, w):
            same += 1
            continue
        w64, g64 = w.to(torch.float64), g.to(torch.float64)
        rel = ((g64 - w64).abs().max()
               / w64.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (rel, k))
        if not rel <= tol:
            raise RuntimeError(f"{tag}: leaf {k} differs by {rel:.3e} of its "
                               f"largest magnitude (tol {tol:.0e})")
    log(f"[{tag}] {same} of {len(want)} leaves bit-equal; the largest "
        f"difference {worst[0]:.3e} of its leaf's magnitude at {worst[1]!r} "
        f"(tol {tol:.0e})")
    return same


def _train_log(tag, history, cfg, tokens: int, peak: float, card: str):
    """Step-time median (first step left out), tokens/s and peak memory
    beside the bound."""
    times = [h[3] for h in history]
    med = statistics.median(times[1:])
    bound = train_bound_ms(cfg.param_count(), tokens)
    log(f"[{tag}] {cfg.name} x{cfg.num_layers} ({cfg.param_count()} "
        f"parameters), {tokens} tokens a step: first step {times[0]:.3f} s, "
        f"median {med * 1e3:.2f} ms over {len(times) - 1} steps = "
        f"{tokens / med:.0f} tokens/s; bound 6 x params x tokens / 67 "
        f"TFLOP/s = {bound:.2f} ms ({bound / (med * 1e3):.3f} of it); peak "
        f"memory {peak / 2**30:.2f} GiB; {card}")


def train_phase(torch) -> dict:
    """Phase 13 (see the module docstring); returns its launch counts."""
    import tempfile
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train_opt(torch, Path(tmp), card)
        log(f"[train] (a) in process {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_llama_width(torch, card)
        log(f"[train] (b) {time.perf_counter() - t0:.1f} s")
        # (a)'s kill and relaunch and (c)'s second miniature run in
        # processes of their own beside (c)'s first, sharing the card (so
        # (c)'s timings are not those of one process alone)
        t_chain = time.perf_counter()
        chain = KillAndResume(Path(tmp))
        first, *others = MINI_ARCHS
        sides = [SideRun("trained_mini", arch, Path(tmp)) for arch in others]
        t0 = time.perf_counter()
        _add(counts, trained_mini(torch, first, card))
        log(f"[train] (c) {first} {time.perf_counter() - t0:.1f} s (beside "
            f"(a)'s kill and relaunch and {others})")
        for side in sides:
            _add(counts, side.finish())
            log(f"[train] (c) {side.arg} in its own process "
                f"{side.seconds:.1f} s")
        chain.finish(torch, out)
        log(f"[train] (a) kill, relaunch and checks "
            f"{time.perf_counter() - t_chain:.1f} s from the kill run's "
            f"start, (c) included")
        del out
    torch.cuda.empty_cache()
    log(f"[train] phase 13 wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}; {card}")
    return counts


def train_opt(torch, tmp: Path, card: str) -> dict:
    """(a) opt-125m through ``python -m repro_torch.launch.train`` in
    process (its checkpoints in ``tmp / "run"``); returns the run
    (:class:`KillAndResume` does the rest)."""
    from repro_torch.launch import train
    run = tmp / "run"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.train(train.build_parser().parse_args(
        TRAIN_ARGS + ["--ckpt-dir", str(run)]))
    cfg, hist = out["cfg"], out["history"]
    log(f"[train-a] {' '.join(TRAIN_ARGS)}: {len(hist)} steps in "
        f"{time.perf_counter() - t0:.1f} s (checkpoints included); final "
        f"loss {out['final_loss']:.4f}; corpus entropy floor "
        f"{out['corpus'].entropy_floor():.4f} nats")
    arg = lambda name: int(TRAIN_ARGS[TRAIN_ARGS.index(name) + 1])
    steps, seq = arg("--steps"), arg("--seq")
    tokens = arg("--global-batch") * seq
    _train_log("train-a", hist, cfg, tokens, torch.cuda.max_memory_allocated(),
               card)
    losses = [h[1] for h in hist]
    first, last20 = losses[0], statistics.mean(losses[-20:])
    log(f"[train-a] loss {first:.4f} at step 0 -> {last20:.4f} (mean of the "
        f"last 20); every 20th: {[round(x, 4) for x in losses[::20]]}")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise RuntimeError("train-a: a loss is not finite, or a step was "
                           "skipped")
    if not last20 <= first - 1.0:
        raise RuntimeError(f"train-a: the last 20 losses average {last20:.4f}"
                           f", not 1 nat below the first {first:.4f}")
    torch.cuda.empty_cache()
    return out


class SideRun:
    """``fn(torch, arg, card)`` (``fn(torch, card)`` when ``arg`` is None)
    of this script run in a process of its own (:func:`side_main`), beside
    the main process; :meth:`finish` waits,
    logs its output and returns the launch counts it returned.  A failure
    there fails the script."""

    def __init__(self, fn: str, arg, tmp: Path):
        self.fn, self.arg = fn, arg
        self.path = tmp / f"side-{fn}-{arg}.json"
        self.t0 = time.perf_counter()
        self.proc = start_child(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.side_main("
             f"{fn!r}, {arg!r}, {str(self.path)!r})"],
            cwd=ROOT, env=child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> dict:
        out, _ = self.proc.communicate(timeout=900)
        self.seconds = time.perf_counter() - self.t0
        for line in out.splitlines():
            log(line)
        if self.proc.returncode != 0:
            raise RuntimeError(f"{self.fn}({self.arg}) failed in its own "
                               f"process (exit {self.proc.returncode})")
        return json.loads(self.path.read_text())


def side_main(fn: str, arg: str, path: str) -> None:
    """The body of a :class:`SideRun` process."""
    die_with_parent()
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _lib
    _lib.lib()
    args = () if arg is None else (arg,)
    counts = globals()[fn](torch, *args, card_name(torch))
    Path(path).write_text(json.dumps(counts))


class KillAndResume:
    """(a)'s second half: the training command started as a subprocess,
    killed (SIGKILL) once step ``--ckpt-every`` is saved and launched again
    unchanged, in a thread of its own so that the main process goes on;
    :meth:`finish` joins it and gates it against the uninterrupted run."""

    def __init__(self, tmp: Path):
        import threading
        self.tmp, self.resumed = tmp, tmp / "resumed"
        self.cmd = [sys.executable, "-m", "repro_torch.launch.train",
                    *TRAIN_ARGS, "--ckpt-dir", str(self.resumed)]
        self.env = child_env()
        self.lines, self.error, self.again = [], None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        from repro_torch.train import checkpoints
        mid = int(TRAIN_ARGS[TRAIN_ARGS.index("--ckpt-every") + 1])
        try:
            t0 = time.perf_counter()
            with open(self.tmp / "killed.log", "w") as f:
                proc = start_child(self.cmd, env=self.env, stdout=f,
                                   stderr=f, cwd=ROOT)
                try:
                    while not (self.resumed / f"step_{mid:08d}").is_dir():
                        if (proc.poll() is not None
                                or time.perf_counter() - t0 > 300):
                            raise RuntimeError(
                                f"train-a: the run to kill ended or stalled "
                                f"before step {mid} was saved")
                        time.sleep(0.01)
                finally:
                    proc.kill()
                    proc.wait()
            at_kill = checkpoints.latest_step(self.resumed)
            self.lines.append(
                f"[train-a] SIGKILL once step_{mid:08d} existed "
                f"({time.perf_counter() - t0:.1f} s after the start); latest "
                f"checkpoint {at_kill}")
            if at_kill != mid:
                raise RuntimeError(f"train-a: the kill came at checkpoint "
                                   f"{at_kill}, not {mid}")
            t0 = time.perf_counter()
            proc = start_child(self.cmd, env=self.env, cwd=ROOT,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
            try:
                out, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
                proc.wait()
            self.again = subprocess.CompletedProcess(
                self.cmd, proc.returncode, out, err)
            self.relaunch_s = time.perf_counter() - t0
        except Exception as e:           # re-raised by finish()
            self.error = e

    def finish(self, torch, out) -> None:
        import numpy as np
        from repro_torch.data import MarkovCorpus
        from repro_torch.launch import calibrate
        from repro_torch.train import checkpoints
        self.thread.join()
        for line in self.lines:
            log(line)
        if self.error is not None:
            raise self.error
        arg = lambda name: int(TRAIN_ARGS[TRAIN_ARGS.index(name) + 1])
        steps, seq, mid = arg("--steps"), arg("--seq"), arg("--ckpt-every")
        again = self.again
        if again.returncode != 0:
            raise RuntimeError(f"train-a: the relaunch failed:\n"
                               f"{again.stderr}")
        said = again.stdout.strip().splitlines()[-1]
        log(f"[train-a] relaunched unchanged in {self.relaunch_s:.1f} s: "
            f"{said}")
        if f"restored checkpoint at step {mid}" not in again.stderr:
            raise RuntimeError(f"train-a: the relaunch did not restore step "
                               f"{mid}")
        if checkpoints.latest_step(self.resumed) != steps:
            raise RuntimeError(f"train-a: the relaunch did not finish at "
                               f"{steps}")
        run = self.tmp / "run"
        leaves = []
        for d in (self.resumed, run):
            with np.load(d / f"step_{steps:08d}" / "arrays.npz") as z:
                leaves.append({k: torch.from_numpy(z[k]) for k in z.files})
        log(f"[train-a] resumed vs uninterrupted step-{steps} checkpoint, "
            f"gated on {TRAIN_TOL:.0e} of each leaf's largest magnitude "
            f"(deterministic algorithms off)")
        _leaves_close(torch, "train-a", *leaves, TRAIN_TOL)
        # launch/calibrate --ckpt reads the same floats
        cfg = out["cfg"]
        cal = calibrate.calibrate(calibrate.build_parser().parse_args([
            "--arch", cfg.name, "--ckpt", str(run), "--method", "rtn",
            "--wbits", "4", "--group", "128", "--calib-samples", "16",
            "--calib-seq", str(seq), "--seed", "0", "--device",
            TRAIN_DEVICE]))
        test = torch.from_numpy(MarkovCorpus(cfg.vocab_size, seed=0).sample(
            16, seq, seed=999))
        mem = calibrate.eval_ppl(out["model"], out["state"].params, test)
        ckpt = cal["report"]["fp_ppl"]
        log(f"[train-a] held-out 16 x {seq} fp perplexity: in memory "
            f"{mem:.4f}, through launch/calibrate --ckpt {ckpt:.4f} (seed-0 "
            f"random weights give ~59256: PERF.md §5); rtn w4a16g128 "
            f"{cal['report']['quant_ppl']:.4f}")
        if not abs(mem - ckpt) <= 1e-6 * mem:
            raise RuntimeError("train-a: the checkpoint calibrate reads gives "
                               "another perplexity than the trained params")
        del cal
        torch.cuda.empty_cache()


def train_llama_width(torch, card: str) -> None:
    """(b) llama-7b widths at depth 2: TRAIN_LLAMA_STEPS steps timed, then
    one more step plain, in two microbatches and under remat, held leaf for
    leaf."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus, make_batch_fn
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamConfig
    from repro_torch.train.step import init_train_state, make_train_step
    arch, depth = TRAIN_LLAMA
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    log(f"[train-b] {arch} widths, depth cut to {depth} of "
        f"{get_config(arch).num_layers} layers (16 B a parameter of params, "
        f"gradients and moments: 108 GB at llama-7b's full depth)")
    corpus = MarkovCorpus(cfg.vocab_size, seed=0)
    batches = make_batch_fn(corpus, 16, 128)
    batch = lambda i: {"tokens": torch.from_numpy(
        batches(i)["tokens"]).to(TRAIN_DEVICE)}
    adam = AdamConfig(lr=3e-4, state_dtype=cfg.opt_state_dtype)
    steps = TRAIN_LLAMA_STEPS
    warmup = max(steps // 20, 5)

    def stepper(**over):
        model = build_model(dataclasses.replace(cfg, **over), TRAIN_DEVICE)
        return model, make_train_step(model, adam, steps, warmup)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step = stepper()
    state = init_train_state(model, 0, adam)
    hist = []
    for i in range(steps):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        hist.append((i, loss, float(m["grad_norm"]),
                     time.perf_counter() - t0))
    _train_log("train-b", hist, cfg, 16 * 128,
               torch.cuda.max_memory_allocated(), card)
    losses = [h[1] for h in hist]
    log(f"[train-b] losses {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError("train-b: a loss is not finite")
    # one more step from step 10 (lr_scale 0.1: the params move), three ways
    probe = batch(steps)
    new, m = step(state, probe)
    want = _named(new)
    for tag, over in (("microbatches 2", dict(microbatches=2)),
                      ("remat", dict(remat=True))):
        _, other = stepper(**over)
        got, mo = other(state, probe)
        rel = abs(float(mo["loss"]) - float(m["loss"])) / float(m["loss"])
        log(f"[train-b] {tag} vs plain step: loss {float(mo['loss']):.6f} "
            f"vs {float(m['loss']):.6f} ({rel:.2e} relative)")
        if not rel <= TRAIN_TOL:
            raise RuntimeError(f"train-b: {tag} changes the loss")
        _leaves_close(torch, f"train-b {tag}", _named(got), want,
                      TRAIN_TOL)
        del got
    del state, new, want
    torch.cuda.empty_cache()


def trained_mini(torch, arch: str, card: str) -> dict:
    """(c) one miniature trained as benchmarks/common.py trains it, the
    paper's methods on the trained tree (held-out perplexity table, the
    W2A16 and W4A4 gates of tests/test_system.py), and, for opt-mini, the
    AffineQuant W4A4 g128 kv8 packed tree served through the Engine beside
    the float tree.  Returns the serving launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.baselines import quantize_model_baseline
    from repro_torch.core.calibration import (CalibConfig, finalize_model,
                                              quantize_dense_model)
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.data import MarkovCorpus, make_batch_fn
    from repro_torch.launch import serve
    from repro_torch.models import layers, transformer
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamConfig
    from repro_torch.serve.quantized import quantize_lm_packed
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_config(arch)
    dev = torch.device(TRAIN_DEVICE)
    model = build_model(cfg, dev)
    corpus = MarkovCorpus(vocab=cfg.vocab_size, branching=4, buckets=128,
                          seed=0)
    batches = make_batch_fn(corpus, 16, 64)
    adam = AdamConfig(lr=3e-3)
    state = init_train_state(model, 0, adam)
    step = make_train_step(model, adam, total_steps=MINI_STEPS, warmup=50)
    t0 = time.perf_counter()
    losses = []
    for i in range(MINI_STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(
            batches(i)["tokens"]).to(dev)})
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    secs = time.perf_counter() - t0
    params = state.params
    del state
    calib = torch.from_numpy(corpus.sample(*MINI_CALIB, seed=777))
    test = torch.from_numpy(corpus.sample(*MINI_TEST, seed=999)).to(dev)

    @torch.no_grad()
    def ppl(p):
        return math.exp(float(model.loss(p, {"tokens": test})))

    fp = ppl(params)
    log(f"[{arch}] trained {MINI_STEPS} steps of 16 x 64 (lr 3e-3, warmup "
        f"50) in {secs:.1f} s ({secs / MINI_STEPS * 1e3:.2f} ms a step): "
        f"loss {losses[0]:.4f} -> {statistics.mean(losses[-20:]):.4f}; "
        f"held-out {MINI_TEST[0]} x {MINI_TEST[1]} perplexity {fp:.4f} "
        f"(gate < {0.5 * cfg.vocab_size:.0f}; entropy floor "
        f"{corpus.entropy_floor():.4f} nats = ppl "
        f"{math.exp(corpus.entropy_floor()):.4f}); {card}")
    if not (all(map(math.isfinite, losses)) and fp < 0.5 * cfg.vocab_size):
        raise RuntimeError(f"{arch}: training did not learn the corpus")
    with torch.no_grad():
        full = transformer.forward(params, cfg, test)

    @torch.no_grad()
    def out_mse(p):
        return float(torch.mean(torch.square(
            transformer.forward(p, cfg, test) - full)))

    table, mse = {"fp": fp}, {}
    t0 = time.perf_counter()
    for w, a in ((4, 16), (2, 16), (4, 4)):
        qc = QuantConfig(w_bits=w, a_bits=a, group_size=0)
        methods = (("rtn", "awq", "gptq", "omniquant", "affinequant")
                   if a == 16 else ("rtn", "omniquant", "affinequant"))
        for method in methods:
            if method in ("omniquant", "affinequant"):
                q, _ = quantize_dense_model(
                    params, cfg, dataclasses.replace(qc, lwc=True),
                    CalibConfig(epochs=MINI_EPOCHS, alpha=0.1,
                                use_affine=method == "affinequant"),
                    calib, log=False)
            else:
                q = quantize_model_baseline(
                    params, cfg, dataclasses.replace(qc, lwc=False), calib,
                    method)
            table[f"{qc.tag()} {method}"] = ppl(q)
            mse[(qc.tag(), method)] = out_mse(q)
            del q
    log(f"[{arch}] held-out perplexity of the trained tree per method "
        f"(per channel; w4a4 as the reference evaluates it: fake-quant "
        f"weights through the float forward), {time.perf_counter() - t0:.1f}"
        f" s: " + ", ".join(f"{k} {v:.4f}" for k, v in table.items()))
    log(f"[{arch}] output MSE against the float tree: "
        + ", ".join(f"{t} {m} {v:.4e}" for (t, m), v in mse.items()))
    w2 = QuantConfig(w_bits=2, a_bits=16, group_size=0).tag()
    aff, omni, rtn = (mse[(w2, m)] for m in ("affinequant", "omniquant",
                                             "rtn"))
    if not (aff < rtn and aff <= omni * 1.02):
        raise RuntimeError(f"{arch}: at W2A16 AffineQuant's output MSE "
                           f"{aff:.4e} is not below RTN's {rtn:.4e} and at "
                           f"most 1.02x OmniQuant-diag's {omni:.4e}")
    w4a4 = table[f"{QuantConfig(w_bits=4, a_bits=4, group_size=0).tag()} "
                 f"affinequant"]
    if not (math.isfinite(w4a4) and w4a4 < 10 * fp):
        raise RuntimeError(f"{arch}: the W4A4 AffineQuant perplexity {w4a4} "
                           f"is not finite and below 10x fp's {fp}")
    counts = zero_counts()
    if arch != "opt-mini":
        return counts
    # AffineQuant W4A4 g128 kv8 packed, served through the Engine
    qcfg = QuantConfig(w_bits=4, a_bits=4, group_size=128, lwc=True,
                       kv_bits=8)
    ccfg = CalibConfig(epochs=MINI_EPOCHS, alpha=0.1)
    fake, info = quantize_dense_model(params, cfg, qcfg, ccfg, calib,
                                      log=False)
    packed = finalize_model(params, info["block_qps"], cfg, qcfg, ccfg,
                            deploy="packed")
    argv = _with(SERVE_ARGS, arch=arch, layers=0, device=dev.type,
                 wbits=4, abits=4, group=128, kvbits=8)
    out, c = _counted_serve(argv, packed)
    require_launched(c, ("w4a8_matmul", "flash_prefill", "flash_decode"),
                     f"{arch}-w4a4")
    _add(counts, c)
    fp_out = _float_run(torch, f"{arch}-fp", _with(argv, kvbits=16), params,
                        counts)
    agree = serve.agreement(_streams(fp_out), _streams(out))
    qm = out["model"]
    with torch.no_grad():
        lg = qm.prefill_chunk(packed, {"tokens": test},
                              qm.init_cache(test.shape[0], test.shape[1]),
                              None)[0]
        kppl = math.exp(float(layers.cross_entropy(lg[:, :-1], test[:, 1:])))
    rtn = quantize_lm_packed(params, cfg, qcfg)
    with torch.no_grad():
        lg = qm.prefill_chunk(rtn, {"tokens": test},
                              qm.init_cache(test.shape[0], test.shape[1]),
                              None)[0]
        rppl = math.exp(float(layers.cross_entropy(lg[:, :-1], test[:, 1:])))
    del rtn, lg
    lp, ls = serve.packed_and_fake_logits(qm, packed, fake, out["prompts"],
                                          _streams(out))
    tf = (lp.argmax(-1) == ls.argmax(-1)).float().mean().item()
    log(f"[{arch}-w4a4] trained AffineQuant w4a4 g128 kv8 served: "
        f"{out['generated']} tokens at {out['tokens_per_s']:.2f} tok/s; "
        f"launches {c}; greedy agreement with the trained float tree "
        f"{agree:.4f} (4 x 32 tokens, the same prompts); held-out perplexity "
        f"through the kernels (a4 activations, kv8) {kppl:.4f} (RTN w4a4 "
        f"g128 kv8 through the same kernels {rppl:.4f}), fake-quant "
        f"simulation {ppl(fake):.4f}, fp {fp:.4f}; teacher-forced argmax "
        f"agreement with the fake-quant tree {tf:.4f} (float activations "
        f"there: reported)")
    _gate_served(torch, f"{arch}-w4a4", out)
    del out, fp_out, packed, fake, params
    torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------------------
# 14. the MoE family: qwen3-moe-30b-a3b W4A4 at published width and depth,
#     its float model, calibration and training, and dbrx-132b W4A4
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 48           # the published depth (packed: ~19 GB)
MOE_FP_LAYERS = 8         # float32 experts: 48 layers would be 122 GB
MOE_CALIB_LAYERS = 2      # phase 8's depth and budget
MOE_TRAIN_LAYERS = 2      # 16 B a parameter of params, gradients, moments
MOE_TRAIN_STEPS = 10
DBRX_ARCH = "dbrx-132b"
DBRX_LAYERS = 4           # 40 packed layers would be ~71 GB
MOE_POOL_PAGES = 10       # 4 x (128 + 32 + 1) positions need 12 pages of 64
MOE_LATER_LAYERS = MESH_MOE_LAYERS   # (a)'s paged, pool and kv4 runs, cut from 48 to
#                           keep the script's time with phase 17 (c)-(e)
# routing flips the per-block check may count: a flip needs a token's
# k-th and (k+1)-th router probabilities within an ulp-sized change of its
# MoE input, so a wrong kernel (most rows far off) fails it, a few flips
# over tens of thousands of rows do not
MOE_FLIP_SHARE = 0.01


def moe_phase(torch) -> dict:
    """Phase 14 (see the module docstring); returns its launch counts."""
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    t0 = time.perf_counter()
    _add(counts, moe_serve(torch, card))
    log(f"[moe] (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(counts, moe_float(torch, card))
    log(f"[moe] (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(counts, moe_calibrate(torch, card))
    log(f"[moe] (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_train(torch, card)
    log(f"[moe] (d) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(counts, dbrx_serve(torch, card))
    log(f"[moe] (e) {time.perf_counter() - t0:.1f} s")
    log(f"[moe] phase 14 wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}; {card}")
    return counts


def _packed_build(torch, tag, argv, counts) -> tuple:
    """Seeded random float layers RTN-packed one at a time at startup
    (quantize_pack, one launch a linear, a layer's experts of a projection
    in one, counted and checked); returns (cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.layers import GATED
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c = zero_counts()
    with counted(c):
        cfg, _, params, _, _ = serve.build_model(
            serve.build_parser().parse_args(argv))
        torch.cuda.synchronize()
    # one launch a stacked leaf: a layer's linears one by one, its experts
    # of each projection in one batched launch
    want = cfg.num_layers * (4 + (3 if cfg.act in GATED else 2))
    full = get_config(cfg.name)
    experts = (f"{cfg.num_experts} experts top-{cfg.top_k} of "
               if cfg.num_experts else "")
    log(f"[{tag}] {cfg.name} x{cfg.num_layers}: d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, {experts}d_ff {cfg.d_ff} {cfg.act}, "
        f"vocab {cfg.vocab_size}, {cfg.norm}; {cfg.param_count()} "
        f"parameters at this depth ({full.param_count()}, "
        f"{full.active_param_count()} active a token, at "
        f"{full.num_layers} layers); init + RTN packing layer by layer "
        f"{time.perf_counter() - t0:.3f} s, {c['quantize_pack']} "
        f"quantize_pack launches, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if c["quantize_pack"] != want:
        raise RuntimeError(f"{tag}: {c['quantize_pack']} quantize_pack "
                           f"launches, not one per stacked leaf ({want})")
    _add(counts, c)
    return cfg, params


def _packed_served(torch, tag, out, c, card) -> None:
    """Log a W4A4 serving run beside its weight-stream bound; gate its
    launches and its 32 valid tokens a request."""
    steps = out["step_seconds"]
    med = statistics.median(steps[1:]) * 1e3
    wb = out["weight_bytes"]
    moe = ("; every step dequantizes every expert to float32"
           if out["cfg"].num_experts else "")
    log(f"[{tag}] {out['cfg'].name} x{out['cfg'].num_layers} {out['tag']}: "
        f"{out['generated']} tokens in {out['seconds']:.3f} s = "
        f"{out['tokens_per_s']:.2f} tok/s (prefill of 4x128 included); first "
        f"step {steps[0]:.4f} s, decode step median {med:.2f} ms over "
        f"{len(steps) - 1} steps against the weight-stream bound "
        f"{wb / HBM_BYTES_PER_S * 1e3:.4f} ms (weight bytes {wb} / 3.35 "
        f"TB/s{moe}); KV bytes {out['kv_bytes']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {c}; "
        f"{card}")
    require_launched(c, ("w4a8_matmul", "flash_prefill", "flash_decode"),
                     tag)
    vocab = out["cfg"].vocab_size
    if any(len(s) != 32 or not all(0 <= t < vocab for t in s)
           for s in _streams(out)):
        raise RuntimeError(f"{tag}: a request did not produce 32 valid "
                           f"tokens")


def moe_serve(torch, card) -> dict:
    """(a) qwen3-moe-30b-a3b W4A4 g128 kv8 at published width and depth
    over the linear cache with the per-block check (routing flips
    counted); phase 17 (c) on this tree; then, at MOE_LATER_LAYERS (the
    tree cut, full width), pages of 64 (streams equal 17c's unsharded
    linear streams at that depth), chunks of 64 into a 10-page pool (must
    preempt and complete) and kv4 paged with the per-block check."""
    from repro_torch.launch.serve import agreement
    counts = zero_counts()
    argv = _with(SERVE_ARGS, arch=MOE_ARCH, layers=MOE_LAYERS)
    _, params = _packed_build(torch, "moe", argv, counts)
    dequant_probe(torch, params, card)
    torch.cuda.reset_peak_memory_stats()
    out, c = _counted_serve(argv, params)
    _packed_served(torch, "moe", out, c, card)
    _add(counts, c)
    _gate_served(torch, "moe", out)
    del out
    torch.cuda.empty_cache()
    # phase 17 (c): this tree on a (1, 2) mesh, its ranks beside the later
    # runs, whose base is one device's linear run at MESH_MOE_LAYERS
    mesh = MeshMoe(torch, params, card)
    base = mesh.streams
    params = dict(params, layers=_depth(params["layers"], MOE_LATER_LAYERS))
    argv = _with(argv, layers=MOE_LATER_LAYERS)
    torch.cuda.empty_cache()
    paged, c = _serve_paged_run(torch, "moe-paged", params, base=argv,
                                page_size=64)
    _add(counts, c)
    if _streams(paged) != base:
        raise RuntimeError("moe-paged: the paged streams differ from the "
                           "linear ones")
    log(f"[moe-paged] x{MOE_LATER_LAYERS}: greedy streams equal the linear "
        f"streams token for token (whole-prompt admission prefills the same "
        f"4 x 128 rows in both layouts, so the expert capacities match)")
    del paged
    pool, c = _serve_paged_run(torch, "moe-pool", params, base=argv,
                               page_size=64, prefill_chunk=64,
                               num_pages=MOE_POOL_PAGES)
    _add(counts, c)
    if pool["preemptions"] < 1:
        raise RuntimeError(f"moe-pool: the {MOE_POOL_PAGES}-page pool never "
                           f"preempted")
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     "moe-pool")
    log(f"[moe-pool] every request completed; greedy agreement with the "
        f"linear streams {agreement(base, _streams(pool)):.4f} (reported: "
        f"expert capacity competes per chunk, the reference's documented "
        f"approximation)")
    del pool
    kv4, c = _serve_paged_run(torch, "moe-kv4", params, base=argv, kvbits=4,
                              max_new=8, page_size=64, prefill_chunk=64)
    _add(counts, c)
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     "moe-kv4")
    _gate_served(torch, "moe-kv4", kv4, page_size=64, chunk=64)
    del kv4, params
    _add(counts, mesh.finish(torch))
    torch.cuda.empty_cache()
    return counts


def dequant_probe(torch, params, card) -> None:
    """Dequantizing one layer's three expert leaves, the work every MoE
    decode step repeats in every layer: the codes through ``unpack``'s
    uint8 byte split (the w4 route) equal those through its 64-bit lane
    route (w3 / w5-7); the median time of each and of the whole
    ``QTensor.dequantize`` (L2 flushed before each call)."""
    from repro_torch.core.packing import unpack, unpack_lanes
    from repro_torch.models.init import layer
    leaves = [v for k, v in sorted(layer(params["layers"], 0)["moe"].items())
              if k != "router"]
    for qt in leaves:
        if not torch.equal(unpack(qt.packed, qt.bits, qt.d_in),
                           unpack_lanes(qt.packed, qt.bits, qt.d_in)):
            raise RuntimeError("unpack's byte split and lane routes differ")
    timer = Timer(torch)
    split, lanes, deq = (timer(lambda: [f(qt) for qt in leaves], reps=5)
                         for f in (
        lambda qt: unpack(qt.packed, qt.bits, qt.d_in),
        lambda qt: unpack_lanes(qt.packed, qt.bits, qt.d_in),
        lambda qt: qt.dequantize()))
    nbytes = sum(qt.nbytes for qt in leaves)
    log(f"[moe] one layer's 3 x {leaves[0].packed.shape[0]} expert leaves "
        f"({nbytes} packed bytes): unpack by uint8 byte split {split:.3f} "
        f"ms, by 64-bit lanes {lanes:.3f} ms (equal codes); whole "
        f"dequantize to float32 {deq:.3f} ms, x {len(params['layers']['ln_attn']['scale'])} "
        f"layers a decode step; {card}")
    del timer


def moe_float(torch, card) -> dict:
    """(b) the float qwen3-moe at published width, depth cut: the float
    Model over the linear cache and pages of 64 (streams equal), and the
    per-block check of the kv16 attention kernels against the plain
    versions (routing flips counted)."""
    from repro_torch.launch import serve
    counts = zero_counts()
    argv = _with(SERVE_ARGS, arch=MOE_ARCH, layers=MOE_FP_LAYERS)
    log(f"[fp-moe] depth cut to {MOE_FP_LAYERS} of {MOE_LAYERS} layers "
        f"(float32 experts: 2.42 GB a layer)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = serve.build_model(serve.build_parser().parse_args(
        _with(argv, fp=True)))[2]
    torch.cuda.synchronize()
    log(f"[fp-moe] random init {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; {card}")
    lin = _float_run(torch, "fp-moe", argv, params, counts)
    base = _streams(lin)
    _gate_served(torch, "fp-moe", lin)
    del lin
    paged = _float_run(torch, "fp-moe-paged", argv, params, counts,
                       paged=True, page_size=64)
    if _streams(paged) != base:
        raise RuntimeError("fp-moe-paged: the paged float streams differ "
                           "from the linear ones")
    log("[fp-moe-paged] greedy streams equal the linear streams token for "
        "token")
    del paged, params
    torch.cuda.empty_cache()
    return counts


def moe_calibrate(torch, card) -> dict:
    """(c) AffineQuant W4A4 g128 kv8 and W4A16 g128 calibration of two
    qwen3-moe layers at published width with phase 8's budget and gates;
    each packed tree through the npz checkpoints and served."""
    counts = zero_counts()
    calib_argv = _with(CALIB_ARGS, arch=MOE_ARCH, layers=MOE_CALIB_LAYERS)
    serve_argv = _with(SERVE_ARGS, arch=MOE_ARCH, layers=MOE_CALIB_LAYERS)
    log(f"[moe-calibrate] {MOE_ARCH} widths, depth cut to "
        f"{MOE_CALIB_LAYERS} of {MOE_LAYERS} layers; 32 x 512 calibration "
        f"tokens, batch 8, 3 epochs, alpha 0.1; the ln_mlp site transforms "
        f"the router and all 128 experts' gate and up projections; {card}")
    params = None
    for run, flags in CALIB_RUNS.items():
        out = calibrate_run(torch, f"moe-calibrate-{run}", calib_argv,
                            serve_argv, flags, counts, params)
        params = out["params"]
        del out
    del params
    torch.cuda.empty_cache()
    return counts


def moe_train(torch, card) -> None:
    """(d) qwen3-moe widths at depth 2: MOE_TRAIN_STEPS steps of 16 x 128
    tokens timed against 6 x active params x tokens / 67 TFLOP/s; then one
    step under remat held to the plain step leaf for leaf, and one step in
    two microbatches held to the mean of the plain losses of its halves
    (capacity raised so no token drops in either: the per-call capacity and
    the load-balance term are per microbatch, as in the reference)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus, make_batch_fn
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamConfig
    from repro_torch.train.step import init_train_state, make_train_step
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS,
                              microbatches=1, remat=False)
    log(f"[moe-train] {MOE_ARCH} widths, depth cut to {MOE_TRAIN_LAYERS} "
        f"of {full.num_layers} layers ({cfg.param_count()} parameters, "
        f"{cfg.active_param_count()} active a token)")
    corpus = MarkovCorpus(cfg.vocab_size, seed=0)
    batches = make_batch_fn(corpus, 16, 128)
    batch = lambda i: {"tokens": torch.from_numpy(
        batches(i)["tokens"]).to(TRAIN_DEVICE)}
    adam = AdamConfig(lr=3e-4, state_dtype=cfg.opt_state_dtype)
    steps = MOE_TRAIN_STEPS

    def stepper(**over):
        model = build_model(dataclasses.replace(cfg, **over), TRAIN_DEVICE)
        return model, make_train_step(model, adam, steps, 5)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step = stepper()
    state = init_train_state(model, 0, adam)
    hist = []
    for i in range(steps):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        hist.append((float(m["loss"]), time.perf_counter() - t0))
    times = [h[1] for h in hist]
    med = statistics.median(times[1:])
    tokens = 16 * 128
    bnd = train_bound_ms(cfg.active_param_count(), tokens)
    losses = [h[0] for h in hist]
    log(f"[moe-train] {tokens} tokens a step: first step {times[0]:.3f} s, "
        f"median {med * 1e3:.2f} ms over {steps - 1} steps = "
        f"{tokens / med:.0f} tokens/s; bound 6 x active params x tokens / "
        f"67 TFLOP/s = {bnd:.2f} ms ({bnd / (med * 1e3):.3f} of it); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}; {card}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError("moe-train: a loss is not finite")
    # one more step, plain and under remat: the moments of one state are
    # dropped before the other is made (a state is 22 GB at this size), so
    # the params (which the moments moved) and the grad norm are compared
    probe = batch(steps)
    new, m = step(state, probe)
    want = _named(new.params)
    del new
    _, remat = stepper(remat=True)
    got, mo = remat(state, probe)
    for name in ("loss", "grad_norm"):
        rel = abs(float(mo[name]) - float(m[name])) / float(m[name])
        log(f"[moe-train] remat vs plain step: {name} {float(mo[name]):.6f} "
            f"vs {float(m[name]):.6f} ({rel:.2e} relative)")
        if not rel <= TRAIN_TOL:
            raise RuntimeError(f"moe-train: remat changes the {name}")
    _leaves_close(torch, "moe-train remat", _named(got.params), want,
                  TRAIN_TOL)
    del got, want
    torch.cuda.empty_cache()
    # two microbatches: no token drops (capacity = every token)
    wide = full.num_experts / full.top_k
    _, plain = stepper(capacity_factor=wide)
    halves = [float(plain(state, {"tokens": probe["tokens"][h]})[1]["loss"])
              for h in (slice(0, 8), slice(8, 16))]
    mean = (halves[0] + halves[1]) / 2
    _, micro = stepper(capacity_factor=wide, microbatches=2)
    _, mm = micro(state, probe)
    rel = abs(float(mm["loss"]) - mean) / mean
    log(f"[moe-train] two microbatches vs the plain step on each half: loss "
        f"{float(mm['loss']):.6f} vs mean {mean:.6f} ({rel:.2e} relative, "
        f"tol {TRAIN_TOL:.0e})")
    if not rel <= TRAIN_TOL:
        raise RuntimeError("moe-train: the microbatched step's loss is not "
                           "the mean of its microbatches' plain losses")
    del state
    torch.cuda.empty_cache()


def dbrx_serve(torch, card) -> dict:
    """(e) dbrx-132b W4A4 g128 kv8 at published width, depth cut: linear
    and pages of 64 (streams equal), the per-block check."""
    counts = zero_counts()
    argv = _with(SERVE_ARGS, arch=DBRX_ARCH, layers=DBRX_LAYERS)
    log(f"[dbrx] depth cut to {DBRX_LAYERS} of 40 layers (a float layer is "
        f"12.7 GB; 40 packed layers would be ~71 GB)")
    _, params = _packed_build(torch, "dbrx", argv, counts)
    torch.cuda.reset_peak_memory_stats()
    out, c = _counted_serve(argv, params)
    _packed_served(torch, "dbrx", out, c, card)
    _add(counts, c)
    paged, c = _serve_paged_run(torch, "dbrx-paged", params, base=argv,
                                page_size=64)
    _add(counts, c)
    if _streams(paged) != _streams(out):
        raise RuntimeError("dbrx-paged: the paged streams differ from the "
                           "linear ones")
    log("[dbrx-paged] greedy streams equal the linear streams token for "
        "token")
    del paged
    _gate_served(torch, "dbrx", out)
    del out, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 15. the recurrent families, and the vlm / audio float paths
# ---------------------------------------------------------------------------

REC_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")   # published width and depth
VLM_ARCH = "paligemma-3b"
AUDIO_ARCH = "hubert-xlarge"
REC_PROMPTS = (128, 128, 96, 96)   # two exact-length prefill groups
REC_NEW = 32
RING_PROMPT = 2040        # griffin: + 32 new tokens wraps its 2,048-slot ring
REC_TOL = 1e-4            # logits, as a share of the largest logit
VLM_TEXT = 128
AUDIO_FRAMES = (4, 512)
REC_TRAIN_LAYERS = 2      # depth cut: the 16 B a parameter of training
REC_TRAIN_STEPS = 10
REC_DEVICE = "cuda"       # "cpu" rehearses the phase with reduced configs


def recurrent_phase(torch) -> dict:
    """Phase 15 (see the module docstring); returns its launch counts."""
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        _add(counts, rec_serve(torch, arch, card))
        log(f"[rec] {arch} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(counts, vlm_serve(torch, card))
    log(f"[vlm] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    audio_forward(torch, card)
    log(f"[audio] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec_train(torch, card)
    log(f"[rec-train] {time.perf_counter() - t0:.1f} s")
    log(f"[rec] phase 15 wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}; {card}")
    return counts


def _float_model(torch, arch: str, tag: str, card: str) -> tuple:
    """(cfg, model, params, weight bytes): the seeded float init at
    published width and depth, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_leaves
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, REC_DEVICE)
    params = model.init(0)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[{tag}] {arch} x{cfg.num_layers} ({cfg.family}): d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}; {n} parameters "
        f"({cfg.param_count()} by the config's formula), "
        f"{nbytes / 1e9:.2f} GB of float32; seeded init "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    return cfg, model, params, nbytes


def _run_engine(torch, model, params, prompts, max_len, counts) -> tuple:
    """Submit ``prompts`` through the Engine's entry points and step it
    dry, launches counted into ``counts``; returns (requests, seconds,
    per-step seconds, engine).  Every request must complete with REC_NEW
    tokens."""
    from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
    eng = Engine(model, params, ServeConfig(max_batch=4, max_len=max_len,
                                            max_new=REC_NEW))
    steps = []
    with counted(counts):
        reqs = [eng.submit(p) for p in prompts]
        t_start = t = time.perf_counter()
        while eng.step():
            now = time.perf_counter()
            steps.append(now - t)
            t = now
    if not all(r.status is RequestStatus.COMPLETED
               and len(r.out_tokens) == REC_NEW for r in reqs):
        raise RuntimeError(f"{model.cfg.name}: a request did not complete "
                           f"with {REC_NEW} tokens")
    return reqs, t - t_start, steps, eng


def _served_vs_forward(torch, tag, model, params, prompt, stream,
                       max_len) -> tuple:
    """One request: the serving path teacher-forced on its stream (prefill,
    then decode steps) against the whole-sequence forward over prompt +
    stream, at the positions that predicted the stream.  Returns (max
    |dlogit| / max |logit|, share of served tokens that are the forward's
    greedy choice or tie it within REC_TOL)."""
    from repro_torch.launch.serve import near_greedy, teacher_forced
    p = torch.as_tensor(prompt, dtype=torch.int32)[None]
    g = torch.as_tensor(stream, dtype=torch.int32)[None]
    served = teacher_forced(model, params, p, g, g.shape[1] - 1, max_len)
    with torch.no_grad():
        full = model.forward(params, {"tokens": torch.cat(
            [p, g[:, :-1]], 1)})[:, p.shape[1] - 1:]
    rel = ((served - full).abs().max() / full.abs().max()).item()
    near = near_greedy(full, g, REC_TOL)
    if not (torch.isfinite(served).all() and rel <= REC_TOL):
        raise RuntimeError(f"{tag}: served logits differ from the "
                           f"whole-sequence forward by {rel:.3e}")
    return rel, near


def rec_serve(torch, arch: str, card: str) -> dict:
    """(a) mamba2-1.3b / (b) recurrentgemma-2b through the Engine on the
    linear cache (exact-length prefill groups; griffin's extra 2,040-token
    request wraps its ring during decode): tok/s, the decode step against
    the weights' stream time, peak memory; prefill(T) + one decode step
    against forward(T + 1); every request's served logits against the
    whole-sequence (windowed) forward, and its stream served alone against
    the batched one under that contract."""
    import numpy as np
    from repro_torch.launch.serve import agreement
    tag = arch.split("-")[0]
    cfg, model, params, wbytes = _float_model(torch, arch, tag, card)
    griffin = cfg.family == "griffin"
    rng = np.random.default_rng(0)
    lens = REC_PROMPTS + ((RING_PROMPT,) if griffin else ())
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_len = max(lens) + REC_NEW + 8
    counts = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    reqs, secs, steps, eng = _run_engine(torch, model, params, prompts,
                                         max_len, counts)
    peak = torch.cuda.max_memory_allocated()
    gen = sum(len(r.out_tokens) for r in reqs)
    med = statistics.median(steps[1:])
    b_ms = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] Engine, linear cache, max_batch 4, prompts {list(lens)}, "
        f"{REC_NEW} new each: {gen} tokens in {secs:.3f} s = "
        f"{gen / secs:.1f} tok/s (prefill included); first step "
        f"{steps[0]:.4f} s; decode step median {med * 1e3:.2f} ms over "
        f"{len(steps) - 1} steps against the weights' stream time "
        f"{b_ms:.3f} ms at 3.35 TB/s ({b_ms / (med * 1e3):.3f} of it); "
        f"peak memory {peak / 2**30:.2f} GiB; cache bytes (states, ring) "
        f"{eng.memory_report()['kv_bytes']}; launches {counts}; {card}")
    del eng
    if griffin:
        require_launched(counts, ("flash_prefill", "flash_decode"), tag)
        log(f"[{tag}] the {RING_PROMPT}-token request decoded positions "
            f"{RING_PROMPT}..{RING_PROMPT + REC_NEW - 2}: its "
            f"{min(max_len, cfg.window)}-slot ring wrapped after "
            f"{cfg.window - RING_PROMPT} of them")
    # prefill(T) + one decode step against forward(T + 1)
    p2 = torch.from_numpy(np.stack(prompts[:2]))
    g0 = torch.tensor([[r.out_tokens[0]] for r in reqs[:2]],
                      dtype=torch.int32)
    with torch.no_grad():
        lg_p, cache = model.prefill(params, {"tokens": p2}, max_len)
        lg_d, _ = model.decode_step(params, g0, cache)
        full = model.forward(params, {"tokens": torch.cat([p2, g0], 1)})
    t = p2.shape[1]
    rel = max(((lg - full[:, i:i + 1]).abs().max()
               / full.abs().max()).item()
              for lg, i in ((lg_p, t - 1), (lg_d, t)))
    log(f"[{tag}] prefill({t}) + decode vs forward({t + 1}) at B 2: max "
        f"|dlogit| / max |logit| {rel:.3e} (tol {REC_TOL:.0e})")
    if not rel <= REC_TOL:
        raise RuntimeError(f"{tag}: prefill + decode differ from forward")
    del cache, full, lg_p, lg_d
    # every request: served logits vs the forward, alone vs batched
    worst, alones = 0.0, []
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        batched = list(r.out_tokens)
        rel, near = _served_vs_forward(torch, tag, model, params, p,
                                       batched, max_len)
        worst = max(worst, rel)
        alone = list(_run_engine(torch, model, params, [p], max_len,
                                 counts)[0][0].out_tokens)
        alones.append(alone)
        near_a = near if alone == batched else _served_vs_forward(
            torch, tag, model, params, p, alone, max_len)[1]
        if not (near == 1.0 and near_a == 1.0):
            raise RuntimeError(f"{tag}: request {i}'s batched or alone "
                               f"stream is not the forward's greedy choice "
                               f"within {REC_TOL:.0e}")
    log(f"[{tag}] served logits (prefill + {REC_NEW - 1} decode steps, "
        f"teacher-forced) vs the whole-sequence forward: max |dlogit| / "
        f"max |logit| {worst:.3e} over {len(reqs)} requests (tol "
        f"{REC_TOL:.0e}); every batched and alone stream's tokens are the "
        f"forward's greedy choice or tie it; "
        f"{sum(a == list(r.out_tokens) for a, r in zip(alones, reqs))} of "
        f"{len(reqs)} streams served alone equal the batched ones (token "
        f"agreement {agreement([list(r.out_tokens) for r in reqs], alones):.4f})")
    del params, model
    torch.cuda.empty_cache()
    return counts


def vlm_serve(torch, card) -> dict:
    """(c) paligemma-3b: Model.prefill over 256 seeded prefix embeddings
    and 128 text tokens (the prefix-LM mask, plain attention) at B 2, then
    REC_NEW greedy decode steps through flash_decode, against the forward
    over prefix + text + tokens; then the Engine on text-only prompts
    (flash_prefill, flash_decode)."""
    import numpy as np
    from repro_torch.launch.serve import near_greedy
    cfg, model, params, wbytes = _float_model(torch, VLM_ARCH, "vlm", card)
    rng = np.random.default_rng(0)
    b, pn = 2, cfg.num_prefix
    prefix = torch.from_numpy((0.02 * rng.standard_normal(
        (b, pn, cfg.d_model))).astype(np.float32)).to(REC_DEVICE)
    text = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, VLM_TEXT)
                                         ).astype(np.int32))
    counts = zero_counts()
    c = zero_counts()
    toks, seq, dec_s = [], [], []
    with counted(c), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": text,
                                           "prefix_embeds": prefix},
                                  pn + VLM_TEXT + REC_NEW)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        seq.append(lg)
        for _ in range(REC_NEW):
            tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
            seq.append(lg)
    _add(counts, c)
    if c["flash_decode"] != REC_NEW * cfg.num_layers:
        raise RuntimeError(f"vlm: {c['flash_decode']} flash_decode launches, "
                           f"not one a layer and step")
    gen = torch.cat(toks, 1)
    with torch.no_grad():
        full = model.forward(params, {"tokens": torch.cat([text, gen.cpu()],
                                                          1),
                                      "prefix_embeds": prefix})
    full = full[:, pn + VLM_TEXT - 1:]
    served = torch.cat(seq, 1)
    rel = ((served - full).abs().max() / full.abs().max()).item()
    med = statistics.median(dec_s)
    b_ms = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"[vlm] prefix {pn} + text {VLM_TEXT} prefilled at B {b} in "
        f"{pre_s:.4f} s (prefix-LM mask: plain attention); {REC_NEW} decode "
        f"steps through flash_decode, median {med * 1e3:.2f} ms against the "
        f"weights' stream time {b_ms:.3f} ms ({b_ms / (med * 1e3):.3f} of "
        f"it); served logits vs forward(prefix + text + tokens): max "
        f"|dlogit| / max |logit| {rel:.3e} (tol {REC_TOL:.0e}); launches "
        f"{c}")
    if not (torch.isfinite(served).all() and rel <= REC_TOL):
        raise RuntimeError("vlm: prefill with a prefix + decode differ from "
                           "the forward")
    del cache, full, served, seq, prefix
    # the Engine on text-only prompts
    prompts = [rng.integers(0, cfg.vocab_size, VLM_TEXT).astype(np.int32)
               for _ in range(4)]
    c = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    reqs, secs, steps, _ = _run_engine(torch, model, params, prompts, 256,
                                       c)
    _add(counts, c)
    require_launched(c, ("flash_prefill", "flash_decode"), "vlm-engine")
    n = sum(len(r.out_tokens) for r in reqs)
    rel, near = _served_vs_forward(torch, "vlm-engine", model, params,
                                   prompts[0], reqs[0].out_tokens, 256)
    log(f"[vlm-engine] 4 text prompts of {VLM_TEXT}, {REC_NEW} new: {n} "
        f"tokens in {secs:.3f} s = {n / secs:.1f} tok/s; decode step median "
        f"{statistics.median(steps[1:]) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; request 0's "
        f"served logits vs the forward {rel:.3e}, served tokens greedy or "
        f"tied {near:.4f} (gate 1.0); launches {c}")
    if near != 1.0:
        raise RuntimeError("vlm-engine: a served token is not the forward's "
                           "greedy choice")
    del params, model
    torch.cuda.empty_cache()
    return counts


def audio_forward(torch, card) -> None:
    """(d) hubert-xlarge: forward and frame loss on AUDIO_FRAMES seeded
    frame embeddings (bidirectional: the first frame's logits must move
    when the last frame does), timed against 2 x params x frames / 67
    TFLOP/s; decode and the serve CLI refused."""
    from repro_torch.launch import serve
    from repro_torch.models.model import ENCODER_ONLY
    cfg, model, params, _ = _float_model(torch, AUDIO_ARCH, "audio", card)
    gen = torch.Generator(device=REC_DEVICE).manual_seed(0)
    b, t = AUDIO_FRAMES
    emb = torch.randn((b, t, cfg.d_model), generator=gen, device=REC_DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=REC_DEVICE, dtype=torch.int32)
    times = []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model.forward(params, {"embeds": emb})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        loss = float(model.loss(params, {"embeds": emb, "labels": labels}))
        moved = emb.clone()
        moved[:, -1] = torch.randn(moved[:, -1].shape, generator=gen,
                                   device=REC_DEVICE)
        d0 = ((model.forward(params, {"embeds": moved})[:, 0]
               - logits[:, 0]).abs().max() / logits.abs().max()).item()
    med = statistics.median(times[1:])
    bms = 2 * cfg.param_count() * b * t / FP32_OPS_PER_S * 1e3
    log(f"[audio] forward over {b} x {t} frames: median {med * 1e3:.2f} ms "
        f"against 2 x params x frames / 67 TFLOP/s = {bms:.2f} ms "
        f"({bms / (med * 1e3):.3f} of it); frame loss {loss:.4f} (ln "
        f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}); a new last "
        f"frame moves the first frame's logits by {d0:.3e} of the largest "
        f"(gate > 1e-4: bidirectional); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (logits.shape == (b, t, cfg.vocab_size)
            and torch.isfinite(logits).all() and math.isfinite(loss)
            and d0 > 1e-4):
        raise RuntimeError("audio: the forward is not a finite "
                           "bidirectional encoder output")
    refused = 0
    for call in (lambda: model.prefill(params, {"tokens": labels}, 8),
                 lambda: model.decode_step(params, labels[:, :1], {}),
                 lambda: serve.build_model(serve.build_parser().parse_args(
                     ["--arch", AUDIO_ARCH, "--fp", "--device",
                      REC_DEVICE]))):
        try:
            call()
        except ValueError as e:
            refused += ENCODER_ONLY in str(e)
    log(f"[audio] prefill, decode_step and the serve CLI refused: {refused} "
        f"of 3 ({ENCODER_ONLY!r})")
    if refused != 3:
        raise RuntimeError("audio: a decode path was not refused")
    del params, model, logits
    torch.cuda.empty_cache()


def rec_train(torch, card) -> None:
    """(e) mamba2-1.3b and recurrentgemma-2b at published width, depth cut
    to REC_TRAIN_LAYERS, REC_TRAIN_STEPS steps of 16 x 128 tokens through
    launch/train (remat per block, the configs' microbatches, no
    checkpoints): step time against 6 x params x tokens / 67 TFLOP/s,
    tokens/s, peak memory; the loss on the batch after the last step must
    fall below the seeded init's loss on that batch."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus, make_batch_fn
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    for arch in REC_ARCHS:
        tag = f"{arch.split('-')[0]}-train"
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=REC_TRAIN_LAYERS)
        model = Model(cfg, REC_DEVICE)
        held = make_batch_fn(MarkovCorpus(vocab=cfg.vocab_size, seed=0), 16,
                             128)(REC_TRAIN_STEPS)["tokens"]
        with torch.no_grad():
            params = model.init(0)
            loss0 = float(model.loss(params, {"tokens": held}))
        del params, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        args = train.build_parser().parse_args(
            ["--arch", arch, "--layers", str(REC_TRAIN_LAYERS), "--steps",
             str(REC_TRAIN_STEPS), "--global-batch", "16", "--seq", "128",
             "--lr", "1e-3", "--ckpt-dir", "", "--seed", "0", "--device",
             REC_DEVICE])
        out = train.train(args)
        hist = out["history"]
        cfg = out["cfg"]
        _train_log(tag, hist, cfg, 16 * 128,
                   torch.cuda.max_memory_allocated(), card)
        losses = [h[1] for h in hist]
        log(f"[{tag}] remat {cfg.remat}, microbatches {cfg.microbatches}; "
            f"losses {[round(x, 4) for x in losses]}; on the batch after the "
            f"last step: seeded init {loss0:.4f}, trained "
            f"{out['final_loss']:.4f}")
        if not (all(map(math.isfinite, losses))
                and out["final_loss"] < loss0):
            raise RuntimeError(f"{tag}: the loss did not fall")
        del out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 16. quantized vlm and audio: paligemma-3b and hubert-xlarge packed W4A4
# ---------------------------------------------------------------------------

QVA_POOL_PAGES = 10       # 4 x (128 + 32 + 1) positions need 12 pages of 64
QVA_CALIB_LAYERS = 2      # phase 8's depth and budget
QVA_BASELINE_LAYERS = 1   # seconds per block: one block of each arch
QVA_STEP_TOKENS = (2, 64)  # hubert's calibration step, card against CPU
QVA_STEP_TOL = (1e-5, 1e-4)   # loss (relative), gradients (of the largest)
QVA_DEVICE = "cuda"       # "cpu" rehearses the phase with reduced configs


def vlm_audio_phase(torch) -> dict:
    """Phase 16 (see the module docstring); returns its launch counts."""
    import tempfile
    t_phase = time.perf_counter()
    card = card_name(torch)
    counts = zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # (c) runs in a process of its own beside (a) and (b), sharing the
        # card with them
        side = SideRun("qva_calibrate", None, Path(tmp))
        for part, fn in (("a", qvlm_serve), ("b", qaudio_serve)):
            t0 = time.perf_counter()
            _add(counts, fn(torch, card))
            log(f"[qva] ({part}) {time.perf_counter() - t0:.1f} s (beside "
                f"(c))")
        _add(counts, side.finish())
        log(f"[qva] (c) in its own process {side.seconds:.1f} s")
    log(f"[qva] phase 16 wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}; {card}")
    return counts


def _qva_runs(torch, tag, argv, params, counts, card) -> list:
    """Phase 3's requests over the linear cache (the per-block check), pages
    of 64 (streams equal the linear ones) and chunks of 64 into a
    QVA_POOL_PAGES-page pool (must preempt and complete; the per-block
    check over pages and chunks).  Returns the linear streams."""
    from repro_torch.launch.serve import agreement
    torch.cuda.reset_peak_memory_stats()
    out, c = _counted_serve(argv, params)
    _packed_served(torch, tag, out, c, card)
    _add(counts, c)
    base = _streams(out)
    _gate_served(torch, tag, out)
    del out
    paged, c = _serve_paged_run(torch, f"{tag}-paged", params, base=argv,
                                page_size=64)
    _add(counts, c)
    if _streams(paged) != base:
        raise RuntimeError(f"{tag}-paged: the paged streams differ from the "
                           f"linear ones")
    log(f"[{tag}-paged] greedy streams equal the linear streams token for "
        f"token")
    del paged
    pool, c = _serve_paged_run(torch, f"{tag}-pool", params, base=argv,
                               page_size=64, prefill_chunk=64,
                               num_pages=QVA_POOL_PAGES)
    _add(counts, c)
    if pool["preemptions"] < 1:
        raise RuntimeError(f"{tag}-pool: the {QVA_POOL_PAGES}-page pool "
                           f"never preempted")
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     f"{tag}-pool")
    log(f"[{tag}-pool] every request completed; greedy agreement with the "
        f"linear streams {agreement(base, _streams(pool)):.4f} (reported, "
        f"not gated: chunked and resumed prefill change the row count of "
        f"float reductions, and at a4 an ulp can move a code)")
    _gate_served(torch, f"{tag}-pool", pool, page_size=64, chunk=64)
    del pool
    torch.cuda.empty_cache()
    return base


def qvlm_serve(torch, card) -> dict:
    """(a) paligemma-3b W4A4 g128 kv8 at published width and depth (18
    layers, MQA of 8 heads of 256, GeGLU d_ff 16,384, a tied 257,216-token
    head), text prompts as the reference serves it: linear, pages, the
    pool, then kv4 paged with the per-block check."""
    counts = zero_counts()
    argv = _with(SERVE_ARGS, arch=VLM_ARCH)
    _, params = _packed_build(torch, "qvlm", argv, counts)
    _qva_runs(torch, "qvlm", argv, params, counts, card)
    kv4, c = _serve_paged_run(torch, "qvlm-kv4", params, base=argv, kvbits=4,
                              max_new=8, page_size=64, prefill_chunk=64)
    _add(counts, c)
    require_launched(c, ("flash_prefill_paged", "flash_decode_paged"),
                     "qvlm-kv4")
    _gate_served(torch, "qvlm-kv4", kv4, page_size=64, chunk=64)
    del kv4, params
    torch.cuda.empty_cache()
    return counts


def qaudio_serve(torch, card) -> dict:
    """(b) hubert-xlarge W4A4 g128 at published width and depth (48 layers,
    16 heads of 80, LayerNorm, GELU, sinusoidal positions, a tied 504-token
    head), served as the reference serves it: the causal token trunk.  At
    kv8 and kv16: linear, pages, the pool.  Gates beside them: kv4 refused
    (80 % 32 != 0); position 0's logits bit for bit unchanged when token 5
    of the prompt changes, position 6's moved (causal, as the
    reference's packed hubert)."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch import serve
    from repro_torch.serve.quantized import QuantizedModel
    counts = zero_counts()
    argv = _with(SERVE_ARGS, arch=AUDIO_ARCH)
    cfg, params = _packed_build(torch, "qaudio", argv, counts)
    for kv in (8, 16):
        _qva_runs(torch, f"qaudio-kv{kv}", _with(argv, kvbits=kv), params,
                  counts, card)
    refused = []
    for call in (lambda: QuantizedModel(cfg, QuantConfig(kv_bits=4),
                                        device=QVA_DEVICE),
                 lambda: serve.build_model(serve.build_parser().parse_args(
                     _with(argv, kvbits=4)), params)):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    log(f"[qaudio] kv4 at head_dim {cfg.resolved_head_dim}: refused "
        f"{len(refused)} of 2 ({refused[:1]})")
    if len(refused) != 2 or not all("head_dim % 32" in e for e in refused):
        raise RuntimeError("qaudio: kv4 at head_dim 80 was not refused")
    model = QuantizedModel(cfg, QuantConfig(w_bits=4, a_bits=4,
                                            group_size=128, kv_bits=8),
                           device=QVA_DEVICE)
    gen = torch.Generator().manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                         dtype=torch.int32)
    moved = toks.clone()
    moved[0, 5] = (moved[0, 5] + 1) % cfg.vocab_size
    zero = torch.zeros((1,), dtype=torch.int32)
    c = zero_counts()
    with torch.no_grad(), counted(c):
        a, b = (model.prefill_chunk(params, {"tokens": t},
                                    model.init_cache(1, 256), zero)[0]
                for t in (toks, moved))
        torch.cuda.synchronize()
    require_launched(c, ("w4a8_matmul", "flash_prefill"), "qaudio-causal")
    _add(counts, c)
    d6 = ((a[0, 6] - b[0, 6]).abs().max() / a.abs().max()).item()
    log(f"[qaudio-causal] token 5 changed: positions 0-4 bit-equal "
        f"{torch.equal(a[0, :5], b[0, :5])}, position 6 moved by {d6:.3e} "
        f"of the largest logit (the reference's packed hubert is causal; "
        f"its calibration and float forward are not)")
    if not (torch.equal(a[0, :5], b[0, :5]) and d6 > 1e-4):
        raise RuntimeError("qaudio: the packed trunk is not causal")
    del params, model, a, b
    torch.cuda.empty_cache()
    return counts


def qva_calibrate(torch, card) -> dict:
    """(c) AffineQuant W4A4 g128 kv8 of QVA_CALIB_LAYERS layers of each
    arch at published width with phase 8's budget and gates (its packed
    tree through the checkpoints, served with the per-block check); the
    hubert calibration step on the card against the CPU; the RTN / AWQ /
    GPTQ baselines at W4A16 g128 on QVA_BASELINE_LAYERS block of each,
    with phase 10's gates and their seconds per block."""
    counts = zero_counts()
    ppl: dict = {}
    base_ppl: dict = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        tag = "qvlm" if arch == VLM_ARCH else "qaudio"
        calib_argv = _with(CALIB_ARGS, arch=arch, layers=QVA_CALIB_LAYERS)
        log(f"[{tag}-calibrate] {arch} widths, depth cut to "
            f"{QVA_CALIB_LAYERS} layers; 32 x 512 calibration tokens, batch "
            f"8, 3 epochs, alpha 0.1 (hubert bidirectional, as the "
            f"reference calibrates it); {card}")
        out = calibrate_run(torch, f"{tag}-calibrate-a", calib_argv,
                            _with(SERVE_ARGS, arch=arch,
                                  layers=QVA_CALIB_LAYERS),
                            CALIB_RUNS["a"], counts)
        rep = out["report"]
        ppl[arch] = {"fp": rep["fp_ppl"], "affine w4a4": rep["quant_ppl"]}
        del out
        torch.cuda.empty_cache()
        if arch == AUDIO_ARCH:
            hubert_step_vs_cpu(torch, card)
        baselines(torch, arch,
                  _with(CALIB_ARGS, arch=arch, layers=QVA_BASELINE_LAYERS),
                  _with(SERVE_ARGS, arch=arch, layers=QVA_BASELINE_LAYERS),
                  counts, base_ppl)
        torch.cuda.empty_cache()
    for depth, table in ((QVA_CALIB_LAYERS, ppl),
                         (QVA_BASELINE_LAYERS, base_ppl)):
        for arch, row in table.items():
            log(f"[qva] {arch} x{depth} held-out 16 x 512 perplexity "
                f"(random weights; hubert: its frame loss on the tokens' "
                f"embeddings): "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return counts


def hubert_step_vs_cpu(torch, card) -> None:
    """One AffineQuant W4A4 g128 calibration step of a hubert-xlarge block
    at published width on QVA_STEP_TOKENS tokens (seeded init and inputs),
    on the card and on the CPU: the loss within QVA_STEP_TOL[0] relative,
    every gradient leaf within QVA_STEP_TOL[1] of its largest magnitude;
    on the card the block's quantized and float forwards are
    bidirectional (a new last token moves position 0's output by more
    than 1e-4 of the largest) and the same block under a causal mask does
    not move it."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import calibration as cal
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.init import init_block
    cfg = get_config(AUDIO_ARCH)
    qcfg = QuantConfig(w_bits=4, a_bits=4, group_size=128, lwc=True)
    ccfg = cal.CalibConfig(epochs=1, alpha=0.1)
    block = init_block(cfg, torch.Generator().manual_seed(0), "cpu")
    b, t = QVA_STEP_TOKENS
    x = torch.randn((b, t, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(t)[None, :]
    qp = cal.init_block_quant_params(block, cfg, qcfg, ccfg)

    def step(dev):
        to = lambda tree: {k: to(v) if isinstance(v, dict) else
                           (v.to(dev) if torch.is_tensor(v) else v)
                           for k, v in tree.items()}
        bp, q, xd = to(block), to(qp), x.to(dev)
        masks = cal._masks(cal._specs_from(q), 1, ccfg, dev)
        leaves = [p.detach().requires_grad_(True)
                  for _, p in cal._learnable(q)]
        paths = [path for path, _ in cal._learnable(q)]
        for path, p in zip(paths, leaves):
            node = q
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = p
        with torch.no_grad():
            target = cal.fp_block_forward(bp, xd, cfg, pos.to(dev))
        out = cal.quant_block_forward(bp, q, xd, cfg, qcfg, masks,
                                      pos.to(dev))
        loss = torch.mean(torch.square(out - target))
        grads = torch.autograd.grad(loss, leaves)
        return bp, q, masks, loss.item(), [g.cpu() for g in grads]

    t0 = time.perf_counter()
    bp, q, masks, loss_d, grads_d = step(QVA_DEVICE)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, _, loss_c, grads_c = step("cpu")
    t_cpu = time.perf_counter() - t0
    dl = abs(loss_d / loss_c - 1)
    dg = max(((gd - gc).abs().max() / gc.abs().max().clamp_min(1e-30)).item()
             for gd, gc in zip(grads_d, grads_c))
    xd = x.to(QVA_DEVICE)
    moved = xd.clone()
    moved[:, -1] = torch.randn((b, cfg.d_model), generator=torch.Generator()
                               .manual_seed(2)).to(QVA_DEVICE)
    pcuda = pos.to(QVA_DEVICE)
    opens = {}
    with torch.no_grad():
        for name, c in (("bidirectional", cfg),
                        ("causal", dataclasses.replace(cfg, causal=True))):
            for kind, fwd in (
                    ("quant", lambda z: cal.quant_block_forward(
                        bp, q, z, c, qcfg, masks, pcuda)),
                    ("float", lambda z: cal.fp_block_forward(bp, z, c,
                                                             pcuda))):
                y0, y1 = fwd(xd), fwd(moved)
                opens[name, kind] = ((y1[:, 0] - y0[:, 0]).abs().max()
                                     / y0.abs().max()).item()
    log(f"[qaudio-step] one W4A4 g128 calibration step of a hubert-xlarge "
        f"block on {b} x {t} tokens: card {t_dev:.3f} s, CPU {t_cpu:.3f} s; "
        f"loss {loss_d:.6e} vs {loss_c:.6e} (rel {dl:.3e}, tol "
        f"{QVA_STEP_TOL[0]:.0e}); largest gradient difference {dg:.3e} of "
        f"the leaf's largest (tol {QVA_STEP_TOL[1]:.0e}); a new last token "
        f"moves position 0's output by {opens} of the largest; {card}")
    if not (dl <= QVA_STEP_TOL[0] and dg <= QVA_STEP_TOL[1]):
        raise RuntimeError("qaudio-step: the card's calibration step departs "
                           "from the CPU's")
    if not (min(opens["bidirectional", k] for k in ("quant", "float")) > 1e-4
            and max(opens["causal", k] for k in ("quant", "float")) == 0.0):
        raise RuntimeError("qaudio-step: the calibration forwards do not "
                           "attend as the config's mask says")


# ---------------------------------------------------------------------------
# 18. training on a mesh
# ---------------------------------------------------------------------------

MESH_TRAIN = ("llama-7b", 2)     # phase 13(b)'s widths and depth
MESH_TRAIN_ROWS = (4, 256)       # a step's global batch: rows x tokens
MESH_TRAIN_STEPS = 3
MESH_TRAIN_WARMUP = 5            # 13(b)'s schedule: max(steps // 20, 5)
MESH_TRAIN_LR = 3e-4
MESH_TRAIN_DEVICE = "cuda"       # "cpu" rehearses the phase (gloo, micro)
# the CPU lane's bounds (tests/test_torch_sharded_train.py): the first
# step's loss, grad norm and leaves within 1e-5, the later steps' within
# 1e-4; a parameter element whose first moment is below 1e-4 of its leaf's
# largest (its gradient nearly cancels: Adam moves it by about lr sign(g))
# within the learning-rate budget, at most 1e-3 of the elements
MESH_TRAIN_TOL = (1e-5, 1e-4)
# (tag, (data, model), int8 reduction) of (b) and (c)
MESH_TRAIN_RUNS = (("1x2", (1, 2), False), ("2x1", (2, 1), False),
                   ("2x1-int8", (2, 1), True))
MESH_TRAIN_CLI = ["--arch", "opt-125m", "--mesh", "host", "--steps", "20",
                  "--global-batch", "16", "--seq", "128", "--ckpt-every",
                  "20", "--seed", "0"]


def mesh_train_phase(torch) -> dict:
    """Phase 18 (see the module docstring); no kernel runs in training, so
    it returns no launches."""
    return MeshTrainRuns(torch).finish(torch)


class MeshTrainRuns:
    """Phase 18: (b)-(c)'s two ranks (:class:`MeshTrainRanks`) start at
    once, and a thread starts (d)'s ``torch.distributed.run`` when they
    end, so the main process could run other work beside them;
    :meth:`finish` waits, runs (a) in the main process (the card then
    free of the phase's processes), gates (b)-(c), checks (d)'s checkpoint
    through ``launch/calibrate`` and returns no launches.  A failure there
    fails the script."""

    def __init__(self, torch):
        import tempfile
        import threading
        self.t0 = time.perf_counter()
        self.card = card_name(torch)
        self.tmp = Path(tempfile.mkdtemp(prefix="mesh-train-"))
        self.ranks = MeshTrainRanks(self.tmp)
        self.cli, self.error = None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        try:
            self.ranks.wait()
            self.cli = mesh_train_cli_run(self.tmp)
        except Exception as e:           # re-raised by finish()
            self.error = e

    def finish(self, torch) -> dict:
        import shutil
        try:
            self.thread.join()
            if self.error is not None:
                raise self.error
            ranks = self.ranks.results()
            log(f"[mesh-train] (b)-(c) two ranks {self.ranks.seconds:.1f} s "
                f"from their start; (d) {self.cli['seconds']:.1f} s after "
                f"them; {time.perf_counter() - self.t0:.1f} s from the "
                f"phase's start to the end of (d)")
            t0 = time.perf_counter()
            single = mesh_train_single(torch, self.card)
            log(f"[mesh-train] (a) {time.perf_counter() - t0:.1f} s")
            mesh_train_gates(ranks, single, self.card)
            mesh_train_cli_check(torch, self.tmp, self.cli, self.card)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        log(f"[mesh-train] phase 18 wall time {time.perf_counter() - self.t0:.1f}"
            f" s from its start; {self.card}")
        return zero_counts()


def _mesh_train_setup(torch, device, arch=MESH_TRAIN,
                      rows=MESH_TRAIN_ROWS) -> tuple:
    """(cfg, model, Adam config, the steps' global batches) of (a)-(c):
    ``arch`` (name, depth), ``rows`` x tokens a step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus, make_batch_fn
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamConfig
    name, depth = arch
    cfg = dataclasses.replace(get_config(name), num_layers=depth)
    fn = make_batch_fn(MarkovCorpus(cfg.vocab_size, seed=0), *rows)
    batches = [{"tokens": torch.from_numpy(fn(i)["tokens"]).to(device)}
               for i in range(MESH_TRAIN_STEPS)]
    return (cfg, build_model(cfg, device),
            AdamConfig(lr=MESH_TRAIN_LR, state_dtype=cfg.opt_state_dtype),
            batches)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed_steps(torch, step, state, batches, keep=None) -> tuple:
    """(final state, [(loss, grad norm, seconds)]), each step timed on
    the host clock between synchronizes; ``keep(i, state)`` after step
    ``i``, outside the timing."""
    hist = []
    for i, b in enumerate(batches):
        _sync(torch)
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        _sync(torch)
        hist.append((loss, gn, time.perf_counter() - t0))
        if keep is not None:
            keep(i, state)
    return state, hist


def _step_line(hist, cfg, tokens: int) -> str:
    """The median step after the first, tokens/s and the share of 6 x
    params x tokens / 67 TFLOP/s."""
    med = statistics.median(h[2] for h in hist[1:])
    bound = train_bound_ms(cfg.param_count(), tokens)
    share = bound / (med * 1e3)
    return (f"first step {hist[0][2]:.3f} s, median {med * 1e3:.2f} ms over "
            f"{len(hist) - 1} steps = {tokens / med:.0f} tokens/s; bound 6 x "
            f"params x tokens / 67 TFLOP/s = {bound:.2f} ms ({share:.3f} of "
            f"it)")


def mesh_train_single(torch, card: str) -> dict:
    """(a) the steps on a 1 x 1 mesh (NCCL, a world of one) against 13(b)'s
    plain step on the same init and batches: bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.parallel import state_bytes
    from repro_torch.train.step import init_train_state, make_train_step
    cfg, model, adam, batches = _mesh_train_setup(torch, MESH_TRAIN_DEVICE,
                                                  MESH_TRAIN, MESH_TRAIN_ROWS)
    tokens = MESH_TRAIN_ROWS[0] * MESH_TRAIN_ROWS[1]
    runs = {}
    for tag in ("plain", "1x1"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(1, 1, device=MESH_TRAIN_DEVICE) if tag == "1x1" \
            else None
        try:
            if mesh is not None and dist.get_backend() != (
                    "nccl" if MESH_TRAIN_DEVICE == "cuda" else "gloo"):
                raise RuntimeError(f"mesh-train-a: a world of one on "
                                   f"{MESH_TRAIN_DEVICE} chose "
                                   f"{dist.get_backend()}")
            state = init_train_state(model, 0, adam, mesh=mesh)
            step = make_train_step(model, adam, MESH_TRAIN_STEPS,
                                   MESH_TRAIN_WARMUP, mesh=mesh)
            state, hist = _timed_steps(torch, step, state, batches)
        finally:
            if mesh is not None:
                dist.destroy_process_group()
        runs[tag] = {"hist": hist, "bytes": state_bytes(state),
                     "peak": torch.cuda.max_memory_allocated(),
                     "state": {k: v.cpu() for k, v in _named(state).items()}}
        del state, step
    plain, one = runs["plain"], runs["1x1"]
    same = sum(torch.equal(one["state"][k], v)
               for k, v in plain["state"].items())
    for tag, run in runs.items():
        log(f"[mesh-train-a] {tag} {cfg.name} x{cfg.num_layers}, "
            f"{MESH_TRAIN_ROWS[0]} x {MESH_TRAIN_ROWS[1]} tokens a step: "
            f"{_step_line(run['hist'], cfg, tokens)}; bytes {run['bytes']}; "
            f"peak memory {run['peak'] / 2**30:.2f} GiB; losses "
            f"{[h[0] for h in run['hist']]}; {card}")
    backend = "nccl" if MESH_TRAIN_DEVICE == "cuda" else "gloo"
    log(f"[mesh-train-a] 1 x 1 mesh ({backend}) vs 13(b)'s plain step: "
        f"{same} of {len(plain['state'])} leaves "
        f"bit-equal after {MESH_TRAIN_STEPS} steps")
    if same != len(plain["state"]) or [h[:2] for h in plain["hist"]] != \
            [h[:2] for h in one["hist"]]:
        raise RuntimeError("mesh-train-a: the 1 x 1 mesh's steps are not "
                           "the plain steps bit for bit")
    return {"hist": plain["hist"], "bytes": plain["bytes"],
            "peak": plain["peak"], "cfg": cfg}


class MeshTrainRanks:
    """(b)-(c): two ranks sharing the card over gloo
    (:func:`mesh_train_rank_main`, one process a rank); :meth:`wait`
    waits, :meth:`results` returns each rank's results."""

    def __init__(self, tmp: Path):
        from repro_torch.launch.mesh import free_port
        self.tmp = tmp
        spec = tmp / "mesh-train.json"
        spec.write_text(json.dumps({"out": str(tmp),
                                    "device": MESH_TRAIN_DEVICE,
                                    "arch": MESH_TRAIN,
                                    "rows": MESH_TRAIN_ROWS}))
        port = free_port()
        self.t0 = time.perf_counter()
        self.procs = [start_child(
            [sys.executable, "-c", f"import chip_smoke; "
             f"chip_smoke.mesh_train_rank_main({r}, 2, {port}, "
             f"{str(spec)!r})"], cwd=ROOT, env=child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]

    def wait(self) -> None:
        """Wait for both ranks (no logging: it may run in a thread)."""
        self.outs = []
        try:
            for proc in self.procs:
                self.outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in self.procs:
                proc.kill()
        self.seconds = time.perf_counter() - self.t0

    def results(self) -> list:
        """Log the ranks' lines and return each rank's results; a rank that
        failed fails the script."""
        for r, (proc, out) in enumerate(zip(self.procs, self.outs)):
            lines = out.splitlines()
            for line in (lines if proc.returncode == 0 else lines[-40:]):
                if line.startswith("[mesh-train") or proc.returncode:
                    log(line if line.startswith("[") else
                        f"[mesh-train rank {r}] {line}")
            if proc.returncode != 0:
                raise RuntimeError(f"mesh-train rank {r} failed (exit "
                                   f"{proc.returncode})")
        return [json.loads((self.tmp / f"mesh-train-rank{r}.json")
                           .read_text()) for r in range(2)]


def _train_specs(mt) -> dict:
    """{checkpoint key: spec} of every leaf of a TrainState on ``mt``'s
    mesh."""
    out = {"1||count": (), "2": ()}

    def walk(spec, path):
        if isinstance(spec, dict):
            for k, v in spec.items():
                walk(v, path + (k,))
            return
        for pre in ("0", "1||mu", "1||nu"):
            out["||".join((pre,) + path)] = spec
    walk(mt.specs, ())
    return out


def _replicated(mt, state) -> dict:
    """{key: [block, digest]} of every leaf some mesh axis of more than one
    rank does not split: its bytes' digest and this rank's coordinates on
    the axes that do split it."""
    import hashlib
    named = _named(state)
    out = {}
    for key, spec in _train_specs(mt).items():
        axes = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if all(a in axes for a, n in mt.sizes.items() if n > 1):
            continue
        block = [[a, mt.coord[a]] for a in sorted(axes)]
        out[key] = [block, hashlib.sha256(
            named[key].detach().cpu().numpy().tobytes()).hexdigest()]
    return out


def _held(torch, tag, got: dict, want: dict, tol: float, device,
          budget: float = 0.0) -> dict:
    """Every leaf of ``got`` within ``tol`` of the largest magnitude of
    ``want``'s (host tensors, compared on ``device``); with ``budget``, a
    parameter element whose first moment in ``want`` is below 1e-4 of
    its leaf's largest is held to ``budget`` instead.  Returns the worst
    share, its leaf, the bit-equal leaves and the elements so held."""
    if sorted(got) != sorted(want):
        raise RuntimeError(f"{tag}: the two trees have other leaves")
    worst, same, near, size = (0.0, ""), 0, 0, 0
    for k, w in want.items():
        g, w = got[k].to(device), w.to(device)
        if torch.equal(g, w):
            same += 1
            continue
        d = (g.double() - w.double()).abs()
        top = w.double().abs().max().clamp_min(1e-30)
        if budget and k.startswith("0||"):
            mu = want["1||mu||" + k[3:]].to(device).double().abs()
            cancels = mu < 1e-4 * mu.max()
            over = (d > tol * top) & cancels
            near += int(over.sum())
            size += w.numel()
            if float(d[cancels].max() if cancels.any() else 0) > budget:
                raise RuntimeError(f"{tag}: leaf {k} moves beyond the "
                                   f"learning-rate budget {budget:.2e}")
            d = d[~cancels]
        rel = float(d.max() / top) if d.numel() else 0.0
        worst = max(worst, (rel, k))
        if not rel <= tol:
            raise RuntimeError(f"{tag}: leaf {k} differs by {rel:.3e} of its "
                               f"largest magnitude (tol {tol:.0e})")
    if size and near > 1e-3 * size:
        raise RuntimeError(f"{tag}: {near} parameter elements with a "
                           f"cancelling gradient, over 1e-3 of {size}")
    return {"worst": worst[0], "at": worst[1], "same": same,
            "leaves": len(want), "near": near}


def _held_to_unsharded(torch, tag, wholes, ref, ref_hist, hist,
                       device) -> dict:
    """(b)'s gates on rank 0: the mesh's losses and states against the
    unsharded steps'."""
    t1, tn = MESH_TRAIN_TOL
    for name, i, tol in (("loss", 0, t1), ("grad norm", 1, t1)):
        rel = abs(hist[0][i] / ref_hist[0][i] - 1)
        if not rel <= tol:
            raise RuntimeError(f"mesh-train-{tag}: the first step's {name} "
                               f"is {rel:.3e} from the unsharded step's")
    rels = [abs(h[0] / r[0] - 1) for h, r in zip(hist, ref_hist)]
    if not max(rels) <= tn:
        raise RuntimeError(f"mesh-train-{tag}: losses {rels} from the "
                           f"unsharded steps'")
    last = MESH_TRAIN_STEPS - 1
    budget = 2 * MESH_TRAIN_LR * MESH_TRAIN_STEPS
    return {"loss_rel": rels,
            "first": _held(torch, f"mesh-train-{tag} step 1", wholes[0],
                           ref[0], t1, device),
            "last": _held(torch, f"mesh-train-{tag} step {last + 1}",
                          wholes[last], ref[last], tn, device, budget)}


def mesh_train_rank_main(rank: int, world: int, port: int, spec: str) -> None:
    """One rank of :class:`MeshTrainRanks`: join the gloo group; rank 0
    first runs the unsharded steps (the yardstick, kept on the host); then
    each of MESH_TRAIN_RUNS from the same init and batches, timed, with
    its bytes, peak memory and replicated leaves' digests; rank 0 holds
    (b)'s whole states to the unsharded ones.  Writes
    ``mesh-train-rank<r>.json``."""
    die_with_parent()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.optim.compression import make_int8_psum
    from repro_torch.train.parallel import MeshTraining, state_bytes
    from repro_torch.train.step import init_train_state, make_train_step
    job = json.loads(Path(spec).read_text())
    device = job["device"]
    if device == "cpu":
        torch.set_num_threads(1)
    backend = init_world(rank, world, port, device)
    cuda = device == "cuda"
    res = {"rank": rank, "backend": backend}
    last = MESH_TRAIN_STEPS - 1
    try:
        cfg, model, adam, batches = _mesh_train_setup(torch, device,
                                                      job["arch"], job["rows"])
        ref = {}
        if rank == 0:
            state = init_train_state(model, 0, adam)
            step = make_train_step(model, adam, MESH_TRAIN_STEPS,
                                   MESH_TRAIN_WARMUP)

            def keep_ref(i, s):
                if i in (0, last):
                    ref[i] = {k: v.cpu() for k, v in _named(s).items()}
            res["unsharded"] = _timed_steps(torch, step, state, batches,
                                            keep_ref)[1]
            del state, step
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
        for tag, shape, int8 in MESH_TRAIN_RUNS:
            mesh = make_mesh(*shape, device=device)
            mt = MeshTraining(model, mesh)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            state = init_train_state(model, 0, adam, mesh=mesh)
            step = make_train_step(
                model, adam, MESH_TRAIN_STEPS, MESH_TRAIN_WARMUP,
                compress_grads=make_int8_psum(mesh) if int8 else None,
                mesh=mesh)
            wholes = {}

            def keep(i, s):
                if not int8 and i in (0, last):
                    wholes[i] = _named(mt.unshard(s))
            state, hist = _timed_steps(torch, step, state, batches, keep)
            run = {"hist": hist, "bytes": state_bytes(state),
                   "peak": torch.cuda.max_memory_allocated() if cuda else 0,
                   "replicated": _replicated(mt, state)}
            if rank == 0 and not int8:
                run["held"] = _held_to_unsharded(torch, tag, wholes, ref,
                                                 res["unsharded"], hist,
                                                 device)
            res[tag] = run
            del state, step, wholes
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(job["out"]) / f"mesh-train-rank{rank}.json").write_text(
        json.dumps(res))


def mesh_train_gates(ranks: list, single: dict, card: str) -> None:
    """(b)-(c)'s cross-rank gates and log lines (rank 0 held its states to
    the unsharded steps)."""
    cfg = single["cfg"]
    tokens = MESH_TRAIN_ROWS[0] * MESH_TRAIN_ROWS[1]
    whole = sum(single["bytes"].values())
    r0 = ranks[0]
    log(f"[mesh-train-b] rank 0's unsharded yardstick (the card shared "
        f"with rank 1 idle): {_step_line(r0['unsharded'], cfg, tokens)}")
    for tag, shape, int8 in MESH_TRAIN_RUNS:
        checked = 0
        for key, (block, digest) in r0[tag]["replicated"].items():
            other = ranks[1][tag]["replicated"][key]
            if other[0] == block:
                checked += 1
                if other[1] != digest:
                    raise RuntimeError(f"mesh-train-{tag}: replicated leaf "
                                       f"{key} differs between the ranks")
        if "int8" not in tag and checked == 0:
            raise RuntimeError(f"mesh-train-{tag}: no replicated leaf was "
                               f"compared")
        for rank in ranks:
            run = rank[tag]
            b = sum(run["bytes"].values())
            log(f"[mesh-train-{'c' if int8 else 'b'}] {tag} rank "
                f"{rank['rank']} ({rank['backend']}, two ranks sharing the "
                f"card): {_step_line(run['hist'], cfg, tokens)}; params + "
                f"moments {run['bytes']} = {b / whole:.3f} of one device's "
                f"{whole}; peak memory {run['peak'] / 2**30:.2f} GiB; "
                f"{card}")
            if not b < whole:
                raise RuntimeError(f"mesh-train-{tag}: rank "
                                   f"{rank['rank']} holds {b} bytes, not "
                                   f"less than one device's {whole}")
        losses = [h[0] for h in r0[tag]["hist"]]
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"mesh-train-{tag}: a loss is not finite")
        if int8:
            plain = [h[0] for h in r0["2x1"]["hist"]]
            log(f"[mesh-train-c] (2, 1) losses with the int8 reduction "
                f"{losses} beside the float mean's {plain}")
            continue
        held = r0[tag]["held"]
        log(f"[mesh-train-b] {tag}: losses {losses} ({max(held['loss_rel']):.3e} "
            f"relative to the unsharded steps' at most, tol "
            f"{MESH_TRAIN_TOL[1]:.0e}); step 1 {held['first']['same']} of "
            f"{held['first']['leaves']} leaves bit-equal, the largest "
            f"difference {held['first']['worst']:.3e} of its leaf's "
            f"magnitude at {held['first']['at']!r} (tol "
            f"{MESH_TRAIN_TOL[0]:.0e}); step {MESH_TRAIN_STEPS} "
            f"{held['last']['worst']:.3e} at {held['last']['at']!r} (tol "
            f"{MESH_TRAIN_TOL[1]:.0e}; {held['last']['near']} elements of "
            f"cancelling gradient held to the learning-rate budget); "
            f"{checked} replicated leaves bit-equal on both ranks")


def mesh_train_cli_run(tmp: Path) -> dict:
    """(d)'s command, run to its end (stopping it stops its workers too);
    no logging (it runs in a thread)."""
    from repro_torch.launch.mesh import free_port
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(free_port()), "-m",
           "repro_torch.launch.train", *MESH_TRAIN_CLI, "--ckpt-dir",
           str(tmp / "cli"), "--device", MESH_TRAIN_DEVICE]
    t0 = time.perf_counter()
    proc = start_child(cmd, cwd=ROOT, env=child_env(), launcher=True,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        stop_child(proc)
    return {"cmd": cmd, "rc": proc.returncode, "out": out, "err": err,
            "seconds": time.perf_counter() - t0}


def mesh_train_cli_check(torch, tmp: Path, run: dict, card: str) -> None:
    """(d) ``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh host``: opt-125m at published width
    and depth on two ranks sharing the card; rank 0 alone prints the final
    line and writes the checkpoint, which ``launch/calibrate --ckpt``
    reads (its held-out fp perplexity below the seed-0 init's)."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus
    from repro_torch.launch import calibrate
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoints
    ckpt, cmd = tmp / "cli", run["cmd"]
    if run["rc"] != 0:
        for line in run["err"].splitlines()[-40:]:
            log(f"[mesh-train-d] {line}")
        raise RuntimeError(f"mesh-train-d: torch.distributed.run exited "
                           f"{run['rc']}")
    done = [line for line in run["out"].splitlines()
            if "done: final loss" in line]
    steps = [line.strip() for line in run["err"].splitlines()
             if re.search(r"\bstep \d+ loss", line)]
    arg = lambda name: MESH_TRAIN_CLI[MESH_TRAIN_CLI.index(name) + 1]
    log(f"[mesh-train-d] {' '.join(cmd[1:7])} ... {' '.join(MESH_TRAIN_CLI)}: "
        f"{run['seconds']:.1f} s (process start, init, checkpoint included); "
        f"rank 0's step lines {steps}; {done}; {card}")
    if len(done) != 1:
        raise RuntimeError(f"mesh-train-d: {len(done)} ranks printed the "
                           f"final line, not rank 0 alone")
    if not math.isfinite(float(done[0].split("final loss ")[1].split()[0])):
        raise RuntimeError("mesh-train-d: the final loss is not finite")
    if checkpoints.latest_step(ckpt) != int(arg("--steps")):
        raise RuntimeError(f"mesh-train-d: no step-{arg('--steps')} "
                           f"checkpoint")
    seq = int(arg("--seq"))
    cal = calibrate.calibrate(calibrate.build_parser().parse_args([
        "--arch", arg("--arch"), "--ckpt", str(ckpt), "--method", "rtn",
        "--wbits", "4", "--group", "128", "--calib-samples", "16",
        "--calib-seq", str(seq), "--seed", "0", "--device",
        MESH_TRAIN_DEVICE]))
    cfg = get_config(arg("--arch"))
    model = build_model(cfg, MESH_TRAIN_DEVICE)
    test = torch.from_numpy(MarkovCorpus(cfg.vocab_size, seed=0).sample(
        16, seq, seed=999))
    init_ppl = calibrate.eval_ppl(model, model.init(0), test)
    trained = cal["report"]["fp_ppl"]
    log(f"[mesh-train-d] launch/calibrate --ckpt reads rank 0's step-"
        f"{arg('--steps')} checkpoint: held-out 16 x {seq} fp perplexity "
        f"{trained:.4f} (the seed-0 init's {init_ppl:.4f}); rtn w4a16g128 "
        f"{cal['report']['quant_ppl']:.4f}")
    if not (math.isfinite(trained) and trained < init_ppl):
        raise RuntimeError("mesh-train-d: the checkpoint calibrate reads is "
                           "not the trained tree")
    del cal
    torch.cuda.empty_cache()


if __name__ == "__main__":
    import signal
    # a SIGTERM ends main() by SystemExit, so that its children are stopped
    signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))
    try:
        main()
    finally:
        stop_children()
