"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--skip-mesh]

``--skip-mesh`` leaves out phases 3b, 3c, 3d, 6c, 6d, 6e, 6f and 6g, to
read the other phases without the ranks' runs.  Phases, in order; any failure exits non-zero and no phase catches its own:

1. build    — compile every CUDA kernel of the port (one nvcc per source,
              all started together), print the build seconds and each
              kernel instantiation's registers and spills from ptxas (the
              full report goes to chiprun_out/build_ptxas.log), and fail if
              a tensor-core instantiation (flash's wgmma, the flash
              backward's wgmma sweeps, the SSD scan's mma), an RG-LRU scan
              instantiation (forward or backward) or an SSD backward
              instantiation (either variant) spills, if flash has no wgmma
              instantiation at head dim 96, or if the flash backward's two
              wgmma sweeps (dk/dv and dq) are not instantiated at every
              head dim bwd_variant sends to wgmma.
2. kernels  — each kernel on the card against its plain PyTorch version on
              the same inputs, at the stated tolerances:
              flash attention: the 7 reference cases, block-shape
              invariance, ragged rejection, the yi-9b serving shape; head
              dim 256 cases (one with window < L) and the recurrentgemma-9b
              prefill shape; head dim 96 cases in fp32 (fma) and bf16; the
              wgmma variant's own bf16 cases (every head dim 16–256, 96
              included, GQA groups 1–16, L = 100, 192, 576, non-causal);
              a sliding window without causal masking on both variants;
              the deepseek-moe-16b prefill shape (MHA, G = 1, hd 128);
              phi-3-vision-4.2b's two prefill shapes (MHA, hd 96, L 512
              and 1088); all five serving shapes must run the wgmma
              variant, and the FMA variant is timed in fp32 at the yi-9b
              shape;
              ssd_scan: the 4 reference cases and the mma variant's bf16
              cases (P 16–128, N 16–128, Q 16–256, 1–8 chunks, a stress
              case whose cum passes −100), all with the final state at
              2e-4, chunk invariance, ragged rejection, the mamba2-370m
              serving shape, which must run the mma variant, and the fma
              variant timed in fp32 at that shape;
              rglru_scan: the 4 reference cases, the long carry, the edge
              cases (L = 1, 100, 300; W = 6, 100) and a long one (L 4096),
              each on the variant its width picks, ragged rejection, the
              recurrentgemma-9b serving shape, which must run the vec4
              variant, timed also with L2 flushed before each call
              (ms_cold) and beside torch.add over the same bytes
              (same_bytes_add_ms: the rate the memory gives this traffic).
              The backward kernels (rglru_scan_bwd, ssd_scan_bwd) through
              the ops Functions against autograd of the plain versions:
              the RG-LRU cases and a padded L (300 → 512); the SSD
              reference cases in fp32 and bf16 with and without a
              final-state gradient, the mma cases (stress case included)
              in fp32 and bf16, and a padded L (200 → 256); fp32 at
              atol = rtol = 1e-4, bf16 dx/dB/dC at rtol 1e-2 (atol 1e-3
              of their scale), ddt and da at 1e-4 of their scale; every
              bf16 case must run the SSD backward's mma variant, every fp32
              one its fma variant; each timed at its training shape, the
              SSD backward also in fp32 (fma).
              The flash backward kernel (flash_attention_bwd) against the
              plain backward (models/flash.flash_bwd_plain, the reference's
              FA2) on the same inputs and lse: the wgmma variant at head
              dims 16, 32, 64, 96, 128 and 256, GQA groups 1, 2, 8 and 16, L
              100 and 192, causal, causal with a window, a window without
              causal, softcap and non-causal, at 3e-2 (the tolerance its CPU
              emulation settled against the JAX reference's gradients); the
              fma variant in fp32 at head dims 8–256 at 1e-4 and in bf16 at
              head dim 8; the flash Function at L 100 padded to 128 against
              fp32 autograd of the dense plain attention; each with exactly
              one launch of the variant bwd_variant picks.  Timed at yi-9b's
              training shape q [2,2048,32,128], k/v [2,2048,4,128] beside
              the plain backward and the library (the backward alone of
              scaled_dot_product_attention with enable_gqa under autograd,
              its device kernels named), and at recurrentgemma-9b's q
              [1,4096,16,256], k/v [1,4096,1,256] (window 2048: no library
              call computes it) and the rank shapes of phases 6c (bf16 and
              fp32), 6d, 6e and 6f, under at_other_shapes.
              Each serving shape is timed: kernel / plain / library / bound,
              as device time from a torch.profiler trace, split by device
              kernel in ms_by_kernel (the host-clock time of a wrapper call
              is reported beside it as call_ms).
3. model    — the yi-9b, mamba2-370m, recurrentgemma-9b, deepseek-moe-16b,
              dbrx-132b, phi-3-vision-4.2b (with its patch prefix) and
              seamless-m4t-medium (with frames; once with a 200-token
              prompt, so 25 frames, not a multiple of a 64-row tile) smoke
              configs in fp32 on the card (kernels) and on the CPU (plain):
              prefill logits within 1e-4, equal greedy tokens, flash
              launches per prefill as the decoder's causal self-attention
              layers imply.
3b. mesh   — the distributed branches on MESH_RANKS = 4 processes that
              share the card, each a rank of a gloo process group
              (``spawn``: the parent has initialised CUDA; NCCL refuses two
              ranks on one device), forming a (2, 2) ("data", "model")
              DeviceMesh whose groups must be gloo; the ranks load the
              kernels this run built and never build one.  (a) yi-9b at
              full width, depth cut to 4 of 48 layers (1.22 B parameters,
              4.9 GB of fp32 a rank): prefill of [4, 512] under the mesh
              context (4 flash launches a rank, wgmma in bf16), the cache
              placed by cache_shardings with shard_kv_seq (a ring of 544
              slots, 272 a model rank), then 2 decode steps through
              attention._decode_seqshard against the same rank's plain
              decode on the unsharded cache: bf16 with the same tokens fed
              to both, logits within 1e-1; fp32 greedy, logits within 1e-4
              and equal tokens; then the bf16 steps again with every gloo
              all-reduce timed.  (b) deepseek-moe-16b at full width, depth
              cut to 2 of 28 layers (1.60 B parameters, 6.4 GB a rank):
              prefill of [4, 512] (1024 tokens a rank, expert capacity 120)
              and 2 decode steps under the context, so moe.apply runs
              apply_ep; each layer's output held against
              parallel.ref.apply_ep_emulated on the same input in the rank's
              process, and the logits against a run with every MoE layer
              emulated, 3e-2 in bf16 and 1e-5 in fp32; the emulation runs
              the ranks' own moe.ep_partial, so each layer's input also goes
              through apply_ep under parallel.ref.no_drop's capacity (1024
              rows a rank; no assignment dropped on either path, counted)
              against moe.apply_ref, with the same tolerances.  Prints the mesh and
              backend, each rank's peak memory, flash launches, step times
              of both decodes, the time in all-reduces and max|d|; a rank
              that fails or outlasts MESH_TIMEOUT fails the run.
3c. mesh serve — prefill and decode on each rank's blocks: the parent
              first runs the plain prefill and decode of each arch on the
              card (and frees them), then MESH_RANKS ranks share the card as
              the (2, 2) ("data", "model") gloo mesh; each rebuilds the
              arch's weights from its seed (bf16 serving weights,
              dryrun.serve_dtype; fp32 in the fp32 runs), keeps its blocks
              by the rule table (FSDP over data, TP over model) and serves them
              through serve/engine.make_prefill_step and make_decode_step
              (DTensor parameters under the mesh context): batch 4 × 512,
              2 decode steps, the cache placed by cache_shardings.  yi-9b at
              full width, 4 of 48 layers (its 4 kv heads over the model
              axis), phi-3-vision-4.2b at full width, 4 of 32 layers, with
              its 576-patch prefix (L 1088), deepseek-moe-16b at full
              width, 2 of 28 layers, at parallel.ref.no_drop's capacity
              (expert parallel), mamba2-370m at full width, 12 of 48
              layers in bf16 and all 48 in fp32 (the SSM state over the
              heads, the B/C conv tails over N; bf16's own drift passes
              1e-1 at 48 layers, see MESH_SERVE), recurrentgemma-9b at full
              width, one (rglru, rglru,
              local) group of its 38 layers (the RG-LRU state over the
              width; the local ring over its one kv head's head_dim), and
              seamless-m4t-medium at full width, 4 + 4 of 12 + 12 layers,
              64 frames, with shard_kv_seq (the rings' 516 slots and the
              projected memory's 64 rows over the model axis: the
              cross-attention's split softmax).  Each in bf16 fed the plain
              run's greedy tokens (logits within 1e-1) and cut to its first
              layer in fp32 (recurrentgemma-9b: its first group;
              seamless-m4t-medium: 1 + 1; mamba2-370m: all 48) greedy, 1
              decode step (logits
              within 1e-4, the tokens equal), the greedy argmax over the
              whole padded vocab; the
              MoE arch's logits where the step's token went to the same
              experts as in the plain run (a bf16 near-tie of its router
              may send a token elsewhere; none may in fp32), each of its
              layer calls against moe.apply_ref on the same input (3e-2 in
              bf16, 1e-5 in fp32); every rank's cache bytes
              the rule table's share; every prefill one kernel launch a
              layer on its dtype's variant at the rank's shape (flash a
              causal self-attention layer: its batch block, its q heads and
              their kv heads; the SSD scan an SSM layer: its heads; the
              RG-LRU scan an RG-LRU layer: its width).  Prints each rank's
              prefill ms, decode ms of each step, all-reduces, their bytes
              and host seconds a pass (every collective timed after a
              synchronise), peak memory and cache bytes; gloo moves every
              byte through host memory, so the times describe the harness,
              not a cluster.  Phase 2 holds and times each kernel at the
              rank's shapes of the bf16 prefills for its row's
              at_other_shapes: flash at yi-9b's q [2,512,16,128], k/v
              [2,512,2,128], recurrentgemma-9b's q [2,512,8,256], k/v
              [2,512,1,256] (window 2048) and seamless-m4t-medium's q/k/v
              [2,512,8,64]; the SSD scan at x [2,512,16,64], B/C
              [2,512,128]; the RG-LRU scan at [2,512,2048].  yi-9b's bf16
              prefill and first decode step on every rank are held against
              the dry run of the same cells on one traced rank of mesh 2x2
              (launch/dryrun.run_cell in a subprocess, beside the parent's
              references, so that the parent never holds a process group):
              gloo's all-reduce calls and bytes equal, each kernel's
              launches equal to its operator calls, the rank's argument
              blocks (tokens int32, as the dry run's) equal to the
              predicted argument bytes, and the peak within 5 % of
              max_memory_allocated over the step (the cuBLAS workspace
              released before it, what stays resident beside the
              arguments taken off); the predicted wire bytes are printed
              beside gloo's bytes.
3d. mesh serve undivided — prefill and decode on each rank's blocks of a
              model axis that does not divide every split dim:
              MESH3_RANKS = 3 ranks share the card as the (1, 3) ("data",
              "model") gloo mesh and serve recurrentgemma-9b at full width,
              one (rglru, rglru, local) group, batch 4 × 512, as phase 3c
              (bf16 fed the plain tokens, 2 decode steps, logits within
              1e-1; the fp32 group greedy, 1 decode step, logits within
              1e-4 and the tokens equal) against phase 3c's plain
              references.  The rule table's guard splits d_ff 12288 over
              the model axis and leaves the RG-LRU width 4096, the 16 q
              heads on their one kv head and the 256000-row vocab whole, so
              every rank computes those whole: each prefill launches flash
              (wgmma) at q [4,512,16,256], k/v [4,512,1,256] and the RG-LRU
              scan (vec4) at [4,512,4096], the whole batch (the data axis
              is 1) and the whole width; the whole fp32 embedding is 4.2 GB
              a rank.  Every rank's cache bytes the rule table's share,
              and its bf16 prefill and first decode step held against the
              dry run of the same cells on a traced rank of mesh 1x3.
4. serve    — launch/serve at full width (random weights from a seed, fp32
              master weights on the card), batch 4, prompt 512, 32 generated
              tokens, for yi-9b, mamba2-370m, recurrentgemma-9b,
              deepseek-moe-16b (full depth, 28 layers; its MoE dispatch
              and expert products are plain PyTorch, as the reference's are
              jnp, and its attention runs the flash kernel),
              phi-3-vision-4.2b (32 layers, MHA at hd 96; text only, as the
              reference's launcher serves it) and seamless-m4t-medium (12
              encoder + 12 decoder layers, frames [4, 64, 1024]; the encoder
              and the cross-attention run the dense plain attention, as the
              reference's do, and launch nothing); each
              kernel's launches counted from 0 per arch and required to be
              exactly what one prefill of that arch runs, every flash launch
              of the bf16 serving path by the wgmma variant, every ssd_scan
              launch by the mma variant and every rglru_scan launch by the
              vec4 variant.
4b. prefix  — phi-3-vision-4.2b through serve/engine.make_prefill_step with
              its 576-patch prefix ([4, 576, 1024] bf16 from a seeded
              generator) before a 512-token prompt, so L = 1088 = 17 × 64
              with no padding, then 31 make_decode_step steps: exactly 32
              flash launches, all wgmma, the cache's pos 1088 after the
              prefill, finite logits; prefill ms, decode ms/token, peak
              memory.
5. workflow — the ByRedundant serve workflow at full width on the port's
              LocalRunner, for yi-9b and mamba2-370m: exactly one detok
              completion, launches per decode replica, and the committed
              tokens equal a direct greedy_generate call.
5c. remote workflow — the same serve workflow on the port's RemoteRunner
              (backends/remote.py): worker processes forked by a
              coordinator process that this script starts after phase 4b
              (``python -c "import chip_smoke; chip_smoke.remote_workflow(...)"``,
              in a session of its own) and that never touches the card (it
              asserts that CUDA is not initialised before and after each
              pool runs); two workers serve aws and one aliyun, the lease
              REMOTE_LEASE_MS.  Each worker builds its own bf16 serving
              weights from the seed on the card at its first decode, one
              worker at a time; the kernels are loaded, never built, there.
              This script first runs the direct greedy_generate calls on the
              same seed's weights (and frees them).  (a) yi-9b at full width
              and depth, batch 2 x 64 prompt tokens, 16 steps: the aws/lambda
              decode replica's worker is SIGKILLed at its output checkpoint's
              commit; exactly one detok completion, the decode records the
              killed attempt, its claim again by the other aws worker after
              the lease and the aliyun backup (both finished), the tokens
              equal to the direct call, the time from the kill to the new
              claim; (b) mamba2-370m at full width and depth, no kill;
              (c) yi-9b, 8 Poisson arrivals (core.traffic.PoissonProcess,
              1 wf/s, seed 0; request i's prompt from seed 100 + i)
              submitted through LoadRunner into one run(): the LoadPoint
              (p50, p99, completions, drops, throughput), no drops, every
              request once and its tokens equal to the direct call for its
              seed, no attempt claimed again.  Every model run in a worker
              launched one prefill's kernels on the bf16 variants: the
              crash policy writes the run's counts (from 0) to a file at the
              decode's output commit, which follows the run at once (a
              worker's counters die with it); every worker that ran no
              model has no CUDA context; each worker's weight build and
              peak max_memory_allocated are printed, and the most memory
              nvidia-smi showed over each part (this script samples it every
              REMOTE_SMI_S while the coordinator runs, outside the
              workers).  Phase 2 holds and times flash and the SSD scan at
              these prefill shapes.
5b. dryrun  — launch/dryrun.run_cell on fake CUDA tensors (nothing launched,
              nothing counted) for the cells this script runs, each held
              against the same call on the card: yi-9b at full width (48
              layers, bf16 weights) prefill of [4, 512] and one decode step
              after it, mamba2-370m's and recurrentgemma-9b's prefills of
              [4, 512], phase 6's training step.  The card's launches must
              equal the trace's operator calls, and the predicted peak (the
              cuBLAS workspaces included: they are released before the
              call, which allocates them again; the dry run's constant is
              checked against the card's) must lie within 5 % of
              torch.cuda.max_memory_allocated() over the call, the
              arguments resident; prints the dry run's FLOPs and their
              ratio to model_flops, ops dispatched beside the profiler's
              device kernels, and the measured MFU (model_flops over the
              median of five timed calls at 989 TFLOP/s).  Phase 6b's
              two recurrent steps are dry-run only; every kernel row gets the
              dry run's FLOPs and bytes a call beside its own (``dryrun``).
              Phase 2 also times each kernel's operator against its CUDA
              implementation called directly (op_call_us, launch_call_us).
6. train    — yi-9b at full width, depth cut to 4 layers (bf16 compute, fp32
              master weights, remat "dots"), batch 2 × 2048 tokens of
              synthetic data: 2 steps of make_train_step from a seeded
              state; each step's loss, grad norm, ms (host clock, ended by
              a synchronise), tokens/s, peak memory and flash launches, all
              of them wgmma and as many as the remat policy implies, and one
              flash backward launch (wgmma) a layer; every
              attention weight of every layer must get a nonzero gradient;
              one more step traced by torch.profiler (device time by class);
              then the same 2 steps with attention differentiated through
              the dense plain version, the step-1 loss and grad norm held
              to the flash path's.
6b. recurrent train — mamba2-370m at full width and depth (48 layers,
              batch 2 × 2048) and recurrentgemma-9b at full width with one
              (rglru, rglru, local) group of 3 layers (batch 1 × 4096),
              remat "dots", 2 steps each: loss, grad norm, ms, tokens/s,
              peak memory, launches per step exactly the forwards twice and
              each backward kernel once a scan layer (every SSD backward
              by the mma variant), nonzero first
              moments for every scan-layer weight, one traced step; then
              the same steps with both scans differentiated by autograd
              through their plain versions, step 1's loss and grad norm
              held to within 1e-3 relative.
6c. mesh train — the sharded train step (make_train_step on a state of
              DTensors placed by param_shardings, under make_ctx's context)
              on MESH_RANKS = 4 processes sharing the card as the (2, 2)
              ("data", "model") gloo mesh: every rank rebuilds phase 6's
              initial state (yi-9b at full width, depth cut to 4 of 48
              layers, remat "dots", bf16 compute) from the same seed and
              keeps its blocks (FSDP over data, TP over model), and runs
              phase 6's batches (2 × 2048; a rank's block 1 × 2048, its
              flash calls q [1,2048,16,128], k/v [1,2048,2,128] with lse):
              2 steps with gather_dtype "" and one with "bfloat16", each
              step's loss within 3e-2 and grad norm within 5e-2 relative of
              phase 6's plain step on the same state and batch (the
              bf16-gathered one against a plain bf16-gathered step from
              phase 6's state), parameters bf16 after the bf16-gathered
              step, 8 wgmma flash launches a step on every rank, step 2
              with every collective timed on the host clock after a
              synchronise; then one fp32 step of the same width cut
              to one layer (flash fma, 2 launches) within 1e-4 relative of
              the plain fp32 step's loss and grad norm, and every rank's
              block of every updated parameter within 1e-4 of the plain
              step's and of every first moment (the gradient, elementwise)
              within 1e-4 of its largest (the loss alone cannot tell the
              ranks apart: the loss reduces over every axis).
              Prints each rank's step ms, collectives, their seconds in the
              timed step and its peak memory beside phase 6's.  Every
              rank's first step is held against the dry run of the same
              cell on one traced rank of mesh 2x2, as phase 3c holds its
              prefill and decode step.
6d. mesh train recurrent — the sharded train step of the recurrent
              families on the MESH_RANKS ranks, spawned again as the (2, 2)
              ("data", "model") gloo mesh on the card, remat "dots", bf16
              compute, batch 2 × 2048 (a rank's block 1 × 2048): (a)
              mamba2-370m at full width (d 1024, 32 heads of 64, N 128,
              chunk 256), depth cut to 8 of 48 layers: a rank's scans run
              16 heads; (b) recurrentgemma-9b at full width (d 4096, W
              4096, d_ff 12288, vocab 256000), one (rglru, rglru, local)
              group: a rank's RG-LRU scans run W 2048 and its local
              attention 8 q heads of hd 256 against the one kv head.  The
              parent first runs the plain steps on the same state (from
              the seed) and batch (the step's ms and launches, exact on
              the bf16 variants), and frees them; each rank rebuilds the
              state from the seed and keeps its blocks.  Per arch: 1 step
              with every collective timed, its loss within 3e-2 and grad
              norm within 5e-2 relative of the plain step's, its launches
              exactly the scan forwards twice and each scan backward once a
              scan layer and flash twice a local layer, all on the bf16
              variants (mma, vec4, wgmma); then one
              fp32 step (mamba2-370m cut
              to one layer, on the fma scans; recurrentgemma-9b's group, on
              flash's fma) within 1e-4 relative of the plain step's loss
              and grad norm, every rank's block of every updated parameter
              (the per-head A_log, D and dt_bias, whose gradient is summed
              over the model axis, included) within 1e-4 of the plain
              step's and of every first moment within 1e-4 of its largest.
              Prints each rank's step ms, collectives a step, their seconds
              in the timed step and its peak memory.  Phase 2 holds and
              times each kernel at a rank's shape here; every row of the
              kernel line gets that entry under at_other_shapes with these
              launches (all ranks, the bf16 steps).
6e. mesh train MoE — the sharded train step of the MoE family on the
              MESH_RANKS ranks, spawned again as the (2, 2) ("data",
              "model") gloo mesh on the card, after the parent has run and
              freed its plain steps: deepseek-moe-16b at full width (64
              routed experts of 1408, top-6, 2 shared; 32 experts a model
              rank, expert parallel), depth cut to 1 of 28 layers, remat
              "dots", bf16 compute, batch 2 × 2048 (a rank's block 1 ×
              2048, its flash calls q/k/v [1,2048,8,128] with lse), at
              parallel.ref.no_drop's capacity factor (E/k: nothing drops,
              so the ranks' expert-parallel layer and the plain one compute
              the same function).  The parent's 2 plain steps are the first
              MoE training steps on the card (ms, tokens/s, peak memory,
              flash launches exact on wgmma); each rank rebuilds the state
              from the seed and keeps its blocks: 2 steps, each step's loss
              within 3e-2 and grad norm within 5e-2 relative of the plain
              step's, the second with every collective timed, one step at
              the config's own capacity factor 1.25 (the assignments each
              rank's experts drop, and the loss, finite and the same on
              every rank; not held against the plain step, which drops
              other assignments), flash exactly twice a layer on wgmma in
              each; then one fp32 step (the same one layer) on flash's fma,
              within 1e-4 relative of the plain fp32 step's loss and grad
              norm, every rank's block of every updated parameter (router,
              experts, shared experts included) within 1e-4 of the plain
              step's and of every first moment within 1e-4 of its largest.
              Prints each rank's step ms, collectives a step, their seconds
              in the timed step, peak memory and state bytes.  Phase 2
              holds and times flash at this rank's shape: the flash row
              gets that entry under at_other_shapes with these launches.
6f. mesh train multimodal — the sharded train step of the VLM and
              enc-dec families on the MESH_RANKS ranks, spawned again as
              the (2, 2) ("data", "model") gloo mesh on the card, after the
              parent has run and freed its plain steps, remat "dots", bf16
              compute, batch 2 × 2048 positions (a rank's block 1 × 2048):
              phi-3-vision-4.2b at full width, depth cut to 4 of 32 layers,
              its 576 patches before 1472 tokens (w_patch replicated; a
              rank's flash calls q/k/v [1,2048,16,96] with lse), and
              seamless-m4t-medium at full width, depth cut to 4 + 4 of 12 +
              12 layers, 256 frames and 2048 tokens (the encoder's
              non-causal attention and the cross-attention tensor-parallel
              on the dense plain attention; a rank's flash calls
              [1,2048,8,64]).  The parent's plain step of each is the
              first training step of either family on the card (ms,
              positions/s, peak memory, flash launches exact on wgmma);
              each rank rebuilds the state from the seed and keeps its
              blocks: 1 step with every collective timed, its loss within
              3e-2 and grad norm within 5e-2 relative of the plain step's,
              one step from the initial state with seq_shard_activations
              against the plain step 1 likewise, flash
              exactly twice a decoder layer on wgmma in each (8 a step);
              then one fp32 step (phi-3-vision-4.2b cut to one layer,
              seamless-m4t-medium to 1 + 1) within 1e-4 relative of the
              plain fp32 step's loss and grad norm, every rank's block of
              every updated parameter (w_patch, w_frame, the encoder, lnx
              and the cross-attention included) within 1e-4 of the plain
              step's and of every first moment within 1e-4 of its largest.
              Prints each rank's step ms, collectives a step, their seconds
              in the timed step, peak memory and state bytes.  Phase 2
              holds and times flash at each arch's rank shape: the flash
              row gets those entries under at_other_shapes with these
              launches.
6g. mesh train undivided — the sharded train step on the MESH3_RANKS
              ranks, spawned again as the (1, 3) mesh: mamba2-370m at full
              width, 8 of 48 layers (phase 6d's config), remat "dots", bf16
              compute, batch 2 × 2048 (the whole batch on every rank), whose
              padded vocab 50304 the model axis of 3 splits and whose 32 SSM
              heads and inner width 2048 it leaves whole: the parent's 2
              plain steps and fp32 one-layer step, then each rank's 2 steps
              and fp32 step held as phase 6d's (loss 3e-2, grad norm 5e-2
              relative; fp32 1e-4, every rank's block of every updated
              parameter and first moment at 1e-4), every step's SSD scan
              forward calls at the rank's shape x [2,2048,32,64] (the mma
              variant; the backward's mma variant as often as the plain
              step's), and each rank's first step held against the dry
              run of the same cell on a traced rank of mesh 1x3.
7. grads    — the flash Function (kernel forward, kernel backward) against
              autograd through the dense plain version on the card: fp32
              on the fma variants, bf16 (forward wgmma, backward wgmma) at
              hd 128, one backward launch each.
8. commit   — the committed trainer at examples/train_pipeline.py's "20m"
              preset, 12 steps in chunks of 4, uninterrupted and with the
              primary controller killed after chunk 2: the same final step,
              losses within 1e-4, one commit per chunk.
9. refuse   — the flash wrapper called outside the flash Function on
              inputs that need a gradient raises NotImplementedError
              instead of dropping the gradient; a backward through the
              mamba2-370m and recurrentgemma-9b smoke configs on the card
              runs through each scan's backward kernel.

Every phase's seconds are logged as it ends (``[time]``).  The script
must end within its 1200 s, so the serving of the recurrent and enc-dec
families on the ranks (phase 3c) was paid for by cuts: phase 3c's second
yi-9b case (``shard_kv_seq``; seamless-m4t-medium runs the slot layout
now), phase 3b (a)'s decode steps (8 → 4), and the timed pass of phases
6c, 6d, 6e and 6f (a further step run only to time its collectives: the
last held step is timed instead).  Phases 3d and 6g were paid for by
phase 3c's fp32 decode steps (2 → 1).  With phase 5c the whole script
took 975.2–1026.0 s on an H100 80GB HBM3 at 700 W, and more than 1200 s
on another card's host (the ranks' gloo collectives move through host
memory, and a slower host stretches every mesh phase), so these cuts
followed: the training steps held on every path, TRAIN_STEPS 3 → 2
(phases 6, 6b, 6c, 6d, 6e, 6f, 6g); the bf16 decode steps of the ranks'
serving, 4 → 2 (phases 3b (a) and (b), 3c and 3d); phase 6e's depth, 2
→ 1 of deepseek-moe-16b's 28 layers (its fp32 step was one layer
already).  Besides, BATCH_WORKERS processes make the training phases'
batches ahead from the start: make_batch rebuilds its Zipf CDF for every
draw, which took 34 s of phase 6b's recurrentgemma-9b batches in that
975.2 s run.  Phase 2's flash backward (its checks and eight timed
shapes, about 14 s) is paid for by what the backward kernel takes out of
the training phases: in the first whole run with it, phase 5b took 42.4 s
and phase 6 6.0 s, against 54.2 and 7.7 s with the plain backward.  Its
yardstick, the plain backward, is timed with CUDA events over 3 calls:
its profiler traces overflowed and spoiled the traces after them (phase 2
took 176.6 s that way).  With the wgmma backward the whole script took
972.2–1007.9 s on an H100 80GB HBM3 at 700 W, so these cuts followed:
the wgmma backward's checks at head dim 32, which no config trains at,
one a mask (20 → 5); phases 6d and 6f hold one bf16 step an arch on the
ranks (2 → 1: phase 6d's second recurrentgemma-9b step alone took 26 s
of the ranks' time); phases 6c, 6e and 6g keep a second step, and every
fp32 step holds each rank's block of every updated parameter.

Phase 2 also holds the flash kernels' log-sum-exp (the backward's input)
against the plain version on both variants and times the forward with it
at the training shape and at a rank's shape in phase 6c, and holds and
times every kernel at a rank's shape in phase 6d, flash at a rank's shape
in phases 6e and 6f, each forward kernel at the rank's shapes of phase 3c,
flash and the RG-LRU scan at phase 3d's, the SSD scan and its backward
at phase 6g's, and flash and the SSD scan (chunk 64) at the prefill shapes
of phase 5c's decode replicas.

Every training phase (6, 6b–6g) checks one flash backward launch a causal
self-attention layer a step, on the variant of its dtype (wgmma in bf16, fma
in fp32), as it checks the scans' backward kernels.

The line before the last is one JSON object with a row per kernel
(flash_attention, ssd_scan, rglru_scan, ssd_scan_bwd, rglru_scan_bwd,
flash_attention_bwd; the backward rows with ptxas registers and spills); the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import fcntl
import functools
import gc
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.backends import shim  # noqa: E402
from repro_torch.backends.remote import RemoteRunner  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.convert import tree_to  # noqa: E402
from repro_torch.core.traffic import ArrivalSchedule, LoadRunner, PoissonProcess  # noqa: E402
from repro_torch.core.workflow import deploy  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.profile_serve import _union_us, kernel_class  # noqa: E402
from repro_torch.models import attention, flash, lm, moe, rglru, ssm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel import mesh_ctx  # noqa: E402
from repro_torch.parallel import ref as mesh_ref  # noqa: E402
from repro_torch.parallel.mesh_ctx import mesh_context  # noqa: E402
from repro_torch.parallel.sharding import (cache_shardings, distribute_tree,  # noqa: E402
                                          gather_rows, local_batch, local_slices,
                                          param_shardings, spec_of)
from repro_torch.serve import workflow  # noqa: E402
from repro_torch.serve.engine import (greedy_generate, greedy_token,  # noqa: E402
                                      make_decode_step, make_prefill_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.commit import CommittedTrainer, batch_to  # noqa: E402
from repro_torch.train.step import make_train_step, train_state_init  # noqa: E402

# the serving point of every arch below (bf16 compute)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
YI = configs.get("yi-9b")
#: phase 5c: the remote pool (worker processes a cloud), its lease (longer
#: than a decode attempt, a worker's first weight build included), the
#: request of parts (a) and (b), the open-loop arrivals of part (c)
#: (request i's prompt from seed REMOTE_TRAFFIC_SEED + i) and the
#: coordinator's time limit
REMOTE_WORKERS = {"aws": 2, "aliyun": 1}
REMOTE_LEASE_MS = 15000.0
REMOTE_BATCH, REMOTE_PROMPT, REMOTE_STEPS, REMOTE_SEED = 2, 64, 16, 11
REMOTE_ARRIVALS, REMOTE_RATE_WF_S, REMOTE_TRAFFIC_SEED = 8, 1.0, 100
REMOTE_TIMEOUT = 600
#: seconds between this script's nvidia-smi samples of the card's memory
#: while phase 5c's coordinator runs
REMOTE_SMI_S = 0.5
YI_SHAPE = (SERVE_BATCH, SERVE_PROMPT, YI.n_heads, YI.n_kv_heads, YI.hd)
REMOTE_FLASH = (REMOTE_BATCH, REMOTE_PROMPT, YI.n_heads, YI.n_kv_heads, YI.hd)
MAMBA = configs.get("mamba2-370m")
RG = configs.get("recurrentgemma-9b")
RG_SHAPE = (SERVE_BATCH, SERVE_PROMPT, RG.n_heads, RG.n_kv_heads, RG.hd)
# deepseek-moe-16b at full width and depth: 28 layers of MHA (G = 1, hd 128)
# and 2 shared + 64 routed experts; its 16.9 B fp32 master weights take 67.5
# of the card's 80 GB
DS = configs.get("deepseek-moe-16b")
DS_SHAPE = (SERVE_BATCH, SERVE_PROMPT, DS.n_heads, DS.n_kv_heads, DS.hd)
# phi-3-vision-4.2b at full width and depth: 32 layers of MHA at hd 96 (3.82
# B parameters, 15.3 GB in fp32); its prefill runs L 512 (text only) and
# 1088 (the 576-patch prefix before 512 tokens)
PHI = configs.get("phi-3-vision-4.2b")
PHI_SHAPE = (SERVE_BATCH, SERVE_PROMPT, PHI.n_heads, PHI.n_kv_heads, PHI.hd)
PHI_PREFIX_SHAPE = (SERVE_BATCH, PHI.n_patches + SERVE_PROMPT, PHI.n_heads, PHI.n_kv_heads,
                    PHI.hd)
# the training point: yi-9b's width at 4 layers (the full 48 would need ~140
# GB of parameters, gradients and moments), batch 2 × 2048 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 2
YI_TRAIN = YI.replace(n_layers=4, remat="dots")
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, YI.n_heads, YI.n_kv_heads, YI.hd)

# the mesh phase: MESH_RANKS processes share the one card (NCCL refuses two
# ranks on a device; gloo all-reduces CUDA tensors through host memory) as a
# (2, 2) ("data", "model") mesh.  (a) yi-9b at full width, depth cut from 48
# layers to 4, batch 4 × 512 prompt tokens and MESH_DECODE decode steps in a
# ring of MESH_MAX_LEN slots (272 a model rank); (b) deepseek-moe-16b at full
# width, depth cut from 28 layers to 2, the same batch and MESH_DS_DECODE
# decode steps
MESH_RANKS, MESH_SHAPE, MESH_AXES = 4, (2, 2), ("data", "model")
MESH_YI = YI.replace(n_layers=4)
MESH_MAX_LEN, MESH_DECODE = 544, 2
MESH_DS = DS.replace(n_layers=2)
MESH_DS_DECODE = 2
MESH_TIMEOUT = 600

# sharded serving (phase 3c): the MESH_RANKS ranks again as the (2, 2)
# ("data", "model") mesh; each rank rebuilds an arch's weights from its seed
# (bf16 serving weights, as the reference's sharded serving cells store
# them: half the bytes of every gather) and keeps its blocks by the rule table,
# then serves its blocks through make_prefill_step and make_decode_step:
# batch 4 × 512 prompt tokens (phi-3-vision-4.2b with its 576 patches first,
# seamless-m4t-medium with 512 // 8 = 64 frames) and MESH_SERVE_DECODE decode
# steps (MESH_SERVE_FP32_DECODE in fp32).  yi-9b at full width, depth cut
# from 48 layers to 4 (its 4 kv heads over the model axis);
# phi-3-vision-4.2b at full width, depth cut from 32 layers to 4;
# deepseek-moe-16b at full width, depth cut from 28 layers to 2, at
# parallel.ref.no_drop's capacity (expert parallel; nothing drops, so the
# ranks compute the plain layer's function); mamba2-370m at full width, its
# depth cut from 48 layers to 12 in bf16 (the SSM state over the heads, the
# B/C conv tails over N); recurrentgemma-9b at full width, one (rglru,
# rglru, local) group of 38 layers (the RG-LRU state over the width, the
# local ring over its one kv head's head_dim); seamless-m4t-medium at full
# width, depth cut to 4 + 4 of 12 + 12 layers, with shard_kv_seq (the rings'
# 516 slots and the projected memory's 64 rows over the model axis).  Each
# against the parent's plain prefill and decode on the same weights: bf16
# fed the plain greedy tokens (logits within MESH_SERVE_BF16_TOL), then in
# fp32 greedy (MESH_SERVE_FP32: logits within MESH_SERVE_FP32_TOL, the
# tokens equal).  mamba2-370m's bf16 depth is bf16's own drift: at all 48
# layers the ranks' bf16 logits lie 1.84e-1 from the plain bf16 run's, as
# far as the plain bf16 run lies from the plain fp32 one (1.98e-1), while
# the fp32 runs agree within 1.55e-5 (12 layers: 7.5e-2; on an H100, PERF.md §6),
# so its fp32 run keeps all 48
MESH_SERVE = {"yi-9b": (YI.replace(n_layers=4), 20),
              "phi-3-vision-4.2b": (PHI.replace(n_layers=4), 21),
              "deepseek-moe-16b": (mesh_ref.no_drop(DS.replace(n_layers=2)), 22),
              "mamba2-370m": (MAMBA.replace(n_layers=12), 23),
              "recurrentgemma-9b": (RG.replace(n_layers=3), 24),
              "seamless-m4t-medium": (configs.get("seamless-m4t-medium").replace(
                  n_layers=4, n_enc_layers=4), 25)}
#: each case's fp32 run: cut to its first layer (recurrentgemma-9b to its
#: first group, so that the local layer is in it; seamless-m4t-medium to 1 +
#: 1), but mamba2-370m at all 48 layers
MESH_SERVE_FP32 = {
    **{arch: cfg.replace(n_layers=1, compute_dtype="float32")
       for arch, (cfg, _) in MESH_SERVE.items()},
    "mamba2-370m": MAMBA.replace(compute_dtype="float32"),
    "recurrentgemma-9b": MESH_SERVE["recurrentgemma-9b"][0].replace(compute_dtype="float32"),
    "seamless-m4t-medium": MESH_SERVE["seamless-m4t-medium"][0].replace(
        n_layers=1, n_enc_layers=1, compute_dtype="float32")}
#: the cases: (arch, context knobs)
MESH_SERVE_CASES = (("yi-9b", {}), ("phi-3-vision-4.2b", {}), ("deepseek-moe-16b", {}),
                    ("mamba2-370m", {}), ("recurrentgemma-9b", {}),
                    ("seamless-m4t-medium", {"shard_kv_seq": True}))
#: decode steps after the prefill: bf16, and the one-layer fp32 runs (cut
#: first: every step gathers the FSDP blocks through gloo; 2 → 1 to pay for
#: phases 3d and 6g)
MESH_SERVE_DECODE, MESH_SERVE_FP32_DECODE = 2, 1
MESH_SERVE_BF16_TOL, MESH_SERVE_FP32_TOL = 1e-1, 1e-4
#: in bf16 the ranks' row-parallel sums round otherwise than the plain
#: products, and a router's near-tie then sends a token to other experts
#: (none may in fp32): an MoE arch's logits are held where the step's token
#: went to the same experts, and each of its layer calls on the rank's
#: blocks against moe.apply_ref on the same input (allclose at atol = rtol
#: of phase 3b's tolerances)
MESH_SERVE_LAYER_TOL = {"bfloat16": 3e-2, "float32": 1e-5}
#: the parent's inputs and plain results, which it writes for the ranks
MESH_SERVE_REFS = os.path.join(ROOT, "build", "mesh_serve_refs.pt")
#: a rank's kernel calls in the sharded bf16 prefills of phase 3c: its batch
#: block of 2 × 512 and its half of the heads or the width: yi-9b's flash
#: (16 of 32 q heads with their 2 of 4 kv heads), recurrentgemma-9b's local
#: flash (8 of 16 q heads on the one kv head, window 2048) and RG-LRU scan
#: (2048 of 4096 lanes), seamless-m4t-medium's decoder flash (8 of 16 heads)
#: and mamba2-370m's SSD scan (16 of 32 heads)
MESH_SERVE_BT = SERVE_BATCH // MESH_SHAPE[0]
MESH_SERVE_FLASH = (MESH_SERVE_BT, SERVE_PROMPT, YI.n_heads // MESH_SHAPE[1],
                    YI.n_kv_heads // MESH_SHAPE[1], YI.hd)
MESH_SERVE_RG_FLASH = (MESH_SERVE_BT, SERVE_PROMPT, RG.n_heads // MESH_SHAPE[1], RG.n_kv_heads,
                       RG.hd)
MESH_SERVE_RGLRU = (MESH_SERVE_BT, SERVE_PROMPT, rglru.width(RG) // MESH_SHAPE[1])
MESH_SERVE_M4T_FLASH = (MESH_SERVE_BT, SERVE_PROMPT, MESH_SERVE["seamless-m4t-medium"][0].n_heads
                        // MESH_SHAPE[1], MESH_SERVE["seamless-m4t-medium"][0].n_kv_heads
                        // MESH_SHAPE[1], MESH_SERVE["seamless-m4t-medium"][0].hd)
MESH_SERVE_SSD = (MESH_SERVE_BT, SERVE_PROMPT, ssm.dims(MAMBA)[1] // MESH_SHAPE[1])

# the sharded training phase: MESH_RANKS processes share the card as the
# (2, 2) ("data", "model") mesh; each rank rebuilds phase 6's initial state
# (YI_TRAIN from _gen(0): yi-9b at full width, depth cut from 48 layers to
# 4) and keeps its blocks by the rule table, then runs phase 6's batches
# (2 × 2048): TRAIN_STEPS steps with gather_dtype "" and one with
# "bfloat16", each held against phase 6's plain step on the same state and
# batch (loss within MESH_TRAIN_LOSS_TOL, grad norm within
# MESH_TRAIN_GNORM_RTOL relative), then one fp32 step of the same width cut
# to one layer (flash fma) against the plain fp32 step (MESH_TRAIN_FP32_RTOL)
MESH_TRAIN_FP32 = YI_TRAIN.replace(n_layers=1, compute_dtype="float32")
MESH_TRAIN_LOSS_TOL, MESH_TRAIN_GNORM_RTOL, MESH_TRAIN_FP32_RTOL = 3e-2, 5e-2, 1e-4
# ... and each rank's block of every parameter and first moment after the
# fp32 step against the plain step's (parameters within
# MESH_TRAIN_PARAM_ATOL, moments within MESH_TRAIN_FP32_RTOL of their block's
# largest), whose leaves the parent writes to this file for the ranks
MESH_TRAIN_PARAM_ATOL = 1e-4
MESH_TRAIN_FP32_REF = os.path.join(ROOT, "build", "mesh_train_fp32_ref.pt")
MESH_TRAIN_TIMEOUT = 900
#: a rank's flash call in the sharded step: its batch block and its heads
MESH_TRAIN_SHAPE = (TRAIN_BATCH // MESH_SHAPE[0], TRAIN_SEQ, YI.n_heads // MESH_SHAPE[1],
                    YI.n_kv_heads // MESH_SHAPE[1], YI.hd)

# the cells phases 3c and 6c hold against the dry run of one traced rank of
# their (2, 2) mesh (launch/dryrun.run_cell at mesh "2x2", in a process of
# its own): yi-9b's sharded prefill and its first decode step (3c: 4 layers,
# bf16 serving weights, a rank's block 2 × 512; the decode cache of
# SERVE_PROMPT + MESH_SERVE_DECODE slots, as the prefill writes it) and its
# first sharded training step (6c: 4 layers, a rank's block 1 × 2048).  The
# rank's prefill writes a ring of those slots where the dry run's writes
# SERVE_PROMPT: its outputs are that much larger
MESH_DRYRUN = {
    "serve": {"prefill": (MESH_SERVE["yi-9b"][0], ShapeSpec(
                  "chip_mesh_prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")),
              "decode": (MESH_SERVE["yi-9b"][0], ShapeSpec(
                  "chip_mesh_decode", SERVE_PROMPT + MESH_SERVE_DECODE, SERVE_BATCH, "decode"))},
    "train": {"train": (YI_TRAIN, ShapeSpec("chip_mesh_train", TRAIN_SEQ, TRAIN_BATCH, "train"))}}
MESH_DRYRUN_TIMEOUT = 300


# H100 SXM5 80GB HBM3 published peaks (launch/hlo_analysis.py): bytes/s and FLOP/s
HBM_BYTES_S = ha.HBM_BW
PEAK_FLOPS = {torch.bfloat16: ha.PEAK_FLOPS, torch.float32: ha.PEAK_FLOPS_FP32}

#: the flash-attention variant's source (the row's "source" names the variant run)
FLASH_SOURCES = {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
                 "fma": "src/repro_torch/kernels/csrc/flash_attention.cu"}

#: the SSD-scan variant's source
SSD_SOURCES = {"mma": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cuh",
               "fma": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
#: the SSD backward variant's source
SSD_BWD_SOURCES = {"mma": "src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu",
                   "fma": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"}

# recurrent training: mamba2-370m at full width and depth, batch 2 × 2048;
# recurrentgemma-9b at full width, depth cut from 38 layers to one (rglru,
# rglru, local) group (its 9 B parameters, gradients and two moments need
# ~140 GB), batch 1 × 4096 so that the 2048 window binds
MAMBA_TRAIN_BATCH = 2
MAMBA_TRAIN = MAMBA.replace(remat="dots")
RG_TRAIN_BATCH, RG_TRAIN_SEQ = 1, 4096
RG_TRAIN = RG.replace(n_layers=3, remat="dots")
#: step 1's loss and gradient norm through the scan kernels against those
#: through the scans' plain versions, relative
STEP1_RTOL = 1e-3

# the sharded training of the recurrent families (phase 6d): the MESH_RANKS
# ranks again as the (2, 2) ("data", "model") mesh, remat "dots", bf16
# compute, batch TRAIN_BATCH × TRAIN_SEQ (a rank's block 1 × 2048; phase 6b's
# 1 × 4096 does not split over a data axis of 2): mamba2-370m at full width,
# its depth cut from 48 layers to 8 (the sharded step's time is gloo's host
# collectives, not the card's), and recurrentgemma-9b at full width, one
# (rglru, rglru, local) group (RG_TRAIN; at L 2048 its window of 2048 does
# not bind, phases 2 and 6b hold the windowed kernel).  Each is held against
# the plain step on the same state and batches (MESH_TRAIN_LOSS_TOL,
# MESH_TRAIN_GNORM_RTOL), then one fp32 step against the plain fp32 step
# (MESH_TRAIN_FP32_RTOL, MESH_TRAIN_PARAM_ATOL): mamba2-370m cut to one
# layer, recurrentgemma-9b's one group (one layer of it would leave the
# stacked slots empty, a config the reference's init refuses)
MESH_REC = {"mamba2-370m": MAMBA.replace(n_layers=8, remat="dots"),
            "recurrentgemma-9b": RG_TRAIN}
MESH_REC_FP32 = {"mamba2-370m": MESH_REC["mamba2-370m"].replace(
                     n_layers=1, compute_dtype="float32"),
                 "recurrentgemma-9b": MESH_REC["recurrentgemma-9b"].replace(
                     compute_dtype="float32")}
#: the batches of phase 6d and the plain fp32 steps' leaves, which the parent
#: writes for the ranks
MESH_REC_INPUTS = os.path.join(ROOT, "build", "mesh_rec_inputs.pt")
MESH_REC_FP32_REF = os.path.join(ROOT, "build", "mesh_rec_fp32_ref_{}.pt")
#: a rank's kernel calls in phase 6d: its batch block (1), and its block of
#: the SSM's heads (16 of 32), of the RG-LRU width (2048 of 4096) and of the
#: local attention's q heads (8 of 16; its one kv head gathered)
MESH_REC_BT = TRAIN_BATCH // MESH_SHAPE[0]
MESH_REC_SSD = (MESH_REC_BT, TRAIN_SEQ, ssm.dims(MAMBA)[1] // MESH_SHAPE[1])
MESH_REC_RGLRU = (MESH_REC_BT, TRAIN_SEQ, rglru.width(RG) // MESH_SHAPE[1])
MESH_REC_FLASH = (MESH_REC_BT, TRAIN_SEQ, RG.n_heads // MESH_SHAPE[1], RG.n_kv_heads, RG.hd)
# the sharded training of the MoE family (phase 6e): the MESH_RANKS ranks
# again as the (2, 2) ("data", "model") mesh, deepseek-moe-16b at full width
# (16 heads of 128, 64 routed experts of 1408, top-6, and 2 shared; 32
# experts a model rank), depth cut from 28 layers to 1 (1.007 B parameters,
# 16.1 GB of parameters, gradients and moments; all 28 would need ~270 GB),
# bf16 compute, batch TRAIN_BATCH × TRAIN_SEQ (a rank's block 1 × 2048), at
# parallel.ref.no_drop's capacity factor E/k, where nothing drops and the
# rank's expert-parallel layer computes the plain one's function: TRAIN_STEPS
# steps held against the plain steps (MESH_TRAIN_LOSS_TOL,
# MESH_TRAIN_GNORM_RTOL), the last with every collective timed, one fp32
# step (MESH_TRAIN_FP32_RTOL, MESH_TRAIN_PARAM_ATOL), then
# one bf16 step at the config's own capacity factor 1.25 (MESH_MOE_CF): the
# share each rank drops, and the loss, finite and the same on every rank (the
# plain step drops other assignments: its capacity is rounded to 128 on all
# the tokens, a rank's to 8 on its own)
MESH_MOE_CF = DS.replace(n_layers=1, remat="dots")
MESH_MOE = mesh_ref.no_drop(MESH_MOE_CF)
MESH_MOE_FP32 = MESH_MOE.replace(n_layers=1, compute_dtype="float32")
#: the batches of phase 6e and the plain fp32 step's leaves, which the parent
#: writes for the ranks
MESH_MOE_INPUTS = os.path.join(ROOT, "build", "mesh_moe_inputs.pt")
MESH_MOE_FP32_REF = os.path.join(ROOT, "build", "mesh_moe_fp32_ref.pt")
#: a rank's flash call in phase 6e: its batch block and its 8 of the 16 heads
#: (MHA: 8 kv heads too), hd 128
MESH_MOE_FLASH = (TRAIN_BATCH // MESH_SHAPE[0], TRAIN_SEQ, DS.n_heads // MESH_SHAPE[1],
                  DS.n_kv_heads // MESH_SHAPE[1], DS.hd)
# the sharded training of the multimodal families (phase 6f): the MESH_RANKS
# ranks again as the (2, 2) ("data", "model") mesh, remat "dots", bf16
# compute, batch TRAIN_BATCH × TRAIN_SEQ positions (a rank's block 1 × 2048):
# phi-3-vision-4.2b at full width (32 MHA heads of 96, d_ff 8192) with its
# 576-patch prefix before 1472 tokens, depth cut from 32 layers to 4 (653 M
# parameters); seamless-m4t-medium at full width (16 MHA heads of 64, d_ff
# 4096, its 256256-row padded vocab) with make_batch's 256 frames (L / 8)
# before 2048 tokens, depth cut from 12 + 12 layers to 4 + 4 (677 M
# parameters).  Each is held against the plain steps on the same state and
# batches (MESH_TRAIN_LOSS_TOL, MESH_TRAIN_GNORM_RTOL), one step with
# seq_shard_activations against the plain step 1 likewise, then one fp32
# step against the plain fp32 step (MESH_TRAIN_FP32_RTOL,
# MESH_TRAIN_PARAM_ATOL): phi-3-vision-4.2b cut to one layer,
# seamless-m4t-medium to 1 + 1
SEAMLESS = configs.get("seamless-m4t-medium")
MESH_MM = {"phi-3-vision-4.2b": PHI.replace(n_layers=4, remat="dots"),
           "seamless-m4t-medium": SEAMLESS.replace(n_layers=4, n_enc_layers=4, remat="dots")}
MESH_MM_FP32 = {"phi-3-vision-4.2b": MESH_MM["phi-3-vision-4.2b"].replace(
                    n_layers=1, compute_dtype="float32"),
                "seamless-m4t-medium": MESH_MM["seamless-m4t-medium"].replace(
                    n_layers=1, n_enc_layers=1, compute_dtype="float32")}
#: the batches of phase 6f and the plain fp32 steps' leaves, which the parent
#: writes for the ranks
MESH_MM_INPUTS = os.path.join(ROOT, "build", "mesh_mm_inputs.pt")
MESH_MM_FP32_REF = os.path.join(ROOT, "build", "mesh_mm_fp32_ref_{}.pt")
#: a rank's flash call in phase 6f: its batch block and its half of the
#: decoder's MHA heads (phi-3-vision-4.2b 16 of 32 at hd 96,
#: seamless-m4t-medium 8 of 16 at hd 64); the encoder and the
#: cross-attention run the dense plain attention
MESH_MM_FLASH = {arch: (TRAIN_BATCH // MESH_SHAPE[0], TRAIN_SEQ, cfg.n_heads // MESH_SHAPE[1],
                        cfg.n_kv_heads // MESH_SHAPE[1], cfg.hd)
                 for arch, cfg in MESH_MM.items()}
# phases 3d and 6g: MESH3_RANKS processes share the card as a (1, 3)
# ("data", "model") mesh, a model axis of 3 that divides few split dims of
# the full configs: the rule table's guard leaves every leaf whose dim it
# does not divide whole, and each rank computes those products whole.
# 3d serves recurrentgemma-9b (MESH_SERVE's: full width, one (rglru, rglru,
# local) group) against phase 3c's plain references: d_ff 12288 split, the
# RG-LRU width 4096, the 16 q heads on one kv head and the 256000-row vocab
# whole.  6g trains mamba2-370m (MESH_REC's: full width, 8 of 48 layers)
# against plain steps on the same state and batches: the padded vocab 50304
# split, its 32 SSM heads and inner width 2048 whole
MESH3_RANKS, MESH3_SHAPE = 3, (1, 3)
#: the (data, model) shape of the mesh of a world of ranks
MESH_SHAPES = {MESH_RANKS: MESH_SHAPE, MESH3_RANKS: MESH3_SHAPE}
MESH3_SERVE_CASES = (("recurrentgemma-9b", {}),)
#: a rank's kernel calls in phase 3d's bf16 prefills: the whole batch (the
#: data axis is 1), every head of the local layer, the whole RG-LRU width
MESH3_SERVE_RG_FLASH = (SERVE_BATCH, SERVE_PROMPT, RG.n_heads, RG.n_kv_heads, RG.hd)
MESH3_SERVE_RGLRU = (SERVE_BATCH, SERVE_PROMPT, rglru.width(RG))
#: ... and in phase 6g's steps: the whole batch and every SSM head
MESH3_TRAIN_SSD = (TRAIN_BATCH, TRAIN_SEQ, ssm.dims(MAMBA)[1])
#: the mamba2-370m batches of phase 6g and the plain fp32 step's leaves,
#: which the parent writes for the ranks
MESH3_TRAIN_INPUTS = os.path.join(ROOT, "build", "mesh3_train_inputs.pt")
MESH3_TRAIN_FP32_REF = os.path.join(ROOT, "build", "mesh3_train_fp32_ref_{}.pt")
# phase 3d's recurrentgemma-9b prefill and first decode step and phase 6g's
# first mamba2-370m step, held against a traced rank of the (1, 3) mesh
MESH_DRYRUN["serve3"] = {
    "prefill": (MESH_SERVE["recurrentgemma-9b"][0], ShapeSpec(
        "chip_mesh3_prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")),
    "decode": (MESH_SERVE["recurrentgemma-9b"][0], ShapeSpec(
        "chip_mesh3_decode", SERVE_PROMPT + MESH_SERVE_DECODE, SERVE_BATCH, "decode"))}
MESH_DRYRUN["train3"] = {"train": (MESH_REC["mamba2-370m"], ShapeSpec(
    "chip_mesh3_train", TRAIN_SEQ, TRAIN_BATCH, "train"))}
#: the traced rank's mesh of each set of cells of MESH_DRYRUN
MESH_DRYRUN_MESH = {"serve": "2x2", "train": "2x2", "serve3": "1x3", "train3": "1x3"}

#: the variant each kernel runs in bf16 compute and in fp32
BF16_VARIANTS = {"flash_attention": "wgmma", "ssd_scan": "mma", "ssd_scan_bwd": "mma",
                 "rglru_scan": "vec4", "rglru_scan_bwd": "vec4", "flash_attention_bwd": "wgmma"}
FP32_VARIANTS = {**BF16_VARIANTS, "flash_attention": "fma", "ssd_scan": "fma",
                 "ssd_scan_bwd": "fma", "flash_attention_bwd": "fma"}

#: the keys of a kernel's line that an entry at another shape repeats
SHAPE_KEYS = ("shape", "variant", "source", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "call_ms", "ms_by_kernel")


KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
                        "src/repro/kernels/flash_attention.py:96"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_sm90.cuh",
                 "src/repro/kernels/ssd_scan.py:75"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:60"),
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu",
                     "no TPU kernel: counterpart of JAX autodiff of src/repro/models/ssm.py:99"),
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "no TPU kernel: counterpart of JAX autodiff of "
                       "src/repro/models/rglru.py:62"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cuh",
                            "no TPU kernel: counterpart of src/repro/models/flash.py:121 "
                            "_flash_bwd_impl"),
}
#: the flash backward's source by variant (the wgmma sweeps' header; the
#: delta pass, the head shares' reduction and the fma kernel in the .cu)
FLASH_BWD_SOURCES = {"wgmma": KERNELS["flash_attention_bwd"][0],
                     "fma": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"}


#: the clock of the last :func:`_lap`
_LAP = [0.0]


def _lap(what: str) -> None:
    """Log the seconds since the last lap: the phases ``what`` just ended."""
    now = time.perf_counter()
    _log(f"[time] {what}: {now - _LAP[0]:.1f}s")
    _LAP[0] = now


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAIL: {msg}")


#: make_batch's batches of this script's training phases, keyed by what a
#: batch depends on: made ahead by BATCH_WORKERS processes while the phases
#: before them run (make_batch draws a Zipf token over the vocab for every
#: position: seconds a batch at recurrentgemma-9b's 256000 words)
BATCH_WORKERS = 3
_BATCHES: dict = {}
_BATCH_POOL: list = []


def _batch_key(cfg, seq: int, batch: int, step: int) -> tuple:
    return cfg.vocab, cfg.n_patches, cfg.frame_input, seq, batch, step


def _prefetch_batches() -> None:
    """Start making every batch that the parent's training phases take (in
    the order the phases take them) in worker processes (``spawn``: this
    process holds a CUDA context) at the lowest priority, behind the
    kernels' build."""
    pool = concurrent.futures.ProcessPoolExecutor(
        BATCH_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(19,))
    _BATCH_POOL.append(pool)
    wanted = [(YI_TRAIN, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS + 1),
              (MAMBA_TRAIN, TRAIN_SEQ, MAMBA_TRAIN_BATCH, TRAIN_STEPS + 1),
              (RG_TRAIN, RG_TRAIN_SEQ, RG_TRAIN_BATCH, TRAIN_STEPS + 1)]
    wanted += [(cfg, TRAIN_SEQ, TRAIN_BATCH, p["steps"])
               for p in MESH_ARCH_PHASES.values() for cfg in p["cfgs"].values()]
    wanted.append((MESH_MOE, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS))
    for cfg, seq, batch, steps in wanted:
        for s in range(steps):
            key = _batch_key(cfg, seq, batch, s)
            if key not in _BATCHES:
                _BATCHES[key] = pool.submit(make_batch, cfg, seq, batch, s)


def _batch(cfg, seq: int, batch: int, step: int = 0) -> dict:
    """``make_batch(cfg, seq, batch, step=step)``: a copy of the batch made
    ahead where there is one (a worker's failure raises here)."""
    made = _BATCHES.get(_batch_key(cfg, seq, batch, step))
    if made is None:
        return make_batch(cfg, seq, batch, step=step)
    return {k: v.copy() for k, v in made.result().items()}


def _stop_batches() -> None:
    """Stop the batch workers (what they have not started is dropped)."""
    while _BATCH_POOL:
        _BATCH_POOL.pop().shutdown(wait=True, cancel_futures=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _each_ms(fn, iters: int = 5, warmup: int = 2) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn`` after ``warmup``,
    each timed alone with CUDA events (host gaps inside a call included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return times


def _host_us(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-clock microseconds per call of ``fn`` issued back to back, the
    device not waited for until after the last (so a call's own host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _device_profile(fn, iters: int = 20, warmup: int = 3):
    """Device time per call, the union of the device intervals in a
    torch.profiler trace of ``iters`` calls over ``iters``, and each device
    kernel's time per call by name (arguments dropped).  A trace that comes
    back without device events (seen once in a run of many traces), or with
    a kernel recorded a number of times that is not a multiple of ``iters``
    (seen once: 7 of 20 launches of one kernel kept), is taken again; after
    three such traces the time is taken with CUDA events, host gaps
    included, and there is no split by kernel (None)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if events and all(n % iters == 0 for n in counts.values()):
            break
        _log("[kernels] torch.profiler recorded no device time or not every launch; "
             "tracing again")
    else:
        _log("[kernels] no device time in three traces: timing with CUDA events")
        return _time_ms(fn, iters, 0), None
    by_kernel = {}
    for e in events:
        name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("(")[0]
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    return _union_us(spans) / 1e3 / iters, by_kernel


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    return _device_profile(fn, iters, warmup)[0]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _qkv(b, l, h, hkv, hd, dtype, seed):
    g = _gen(seed)
    mk = lambda n: torch.randn((b, l, n, hd), generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(h), mk(hkv), mk(hkv)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(what: str, got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> float:
    torch.cuda.synchronize()
    err = _max_err(got, want)
    _log(f"[kernels] {what}: max|d|={err:.3e} (atol {atol}, rtol {rtol})")
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        _fail(f"{what} max|d| {err}")
    return err


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _row(name: str, err: float, kernel, plain, nbytes: int, flops: int,
         dtype: torch.dtype, library, shape: str, op=None, launch=None,
         plain_calls: int = 0) -> dict:
    """One kernel's line.  ``kernel``, ``plain`` and ``library`` are
    zero-argument calls (``library`` may be None); ms, plain_ms and library_ms
    are their device times, call_ms the kernel wrapper's host-clock time per
    call.  ``op`` calls the registered operator and ``launch`` its CUDA
    implementation directly: their host times (op_call_us, launch_call_us)
    give the dispatcher's cost of a call.  The least time for the same work
    is the larger of its bytes (each input read once, each output written
    once) at the memory rate and its operations at the inputs' type peak
    (``flops``: the kernel module's formula, the one the dry run counts).
    With ``plain_calls`` the plain version is timed with CUDA events over
    that many calls instead (a plain version that launches thousands of
    kernels a call overflows the profiler's buffers, and the traces after
    it come back incomplete)."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    source, replaces = KERNELS[name]
    kernel_ms, by_kernel = _device_profile(kernel)
    plain_ms = _time_ms(plain, plain_calls, 1) if plain_calls else _device_ms(plain)
    library_ms, library_by_kernel = (_device_profile(library) if library is not None
                                     else (None, None))
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": None, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "shape": shape, "call_ms": _time_ms(kernel),
           "ms_by_kernel": by_kernel, "bytes": nbytes, "flops": flops}
    if plain_calls:
        row["plain_timed_by"] = f"CUDA events over {plain_calls} calls"
    if library is not None:     # the device kernels the library call ran
        row["library_ms_by_kernel"] = library_by_kernel
    if op is not None:
        row["op_call_us"], row["launch_call_us"] = _host_us(op), _host_us(launch)
        _log(f"[kernels] {name} host time of a call (host clock, before the device waits): "
             f"the operator {row['op_call_us']:.2f} us, its CUDA implementation called "
             f"directly {row['launch_call_us']:.2f} us")
    lib = f"{library_ms:.4f}" if library_ms is not None else "null"
    split = (", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()) if by_kernel
             else "not traced")
    _log(f"[kernels] {name} at {shape}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
         f"library_ms={lib} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: "
         f"{nbytes} B, {flops} FLOP); call_ms={row['call_ms']:.4f} (host clock); "
         f"by device kernel: {split}")
    return row


def _ptxas_report(log: str) -> list:
    """(function, registers, spill stores, spill loads) per kernel
    instantiation in an ``nvcc -Xptxas -v`` log."""
    rows, fn, spills = [], None, None
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        elif fn and "spill stores" in line:
            n = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (n[1], n[2])
        elif fn and spills and "Used " in line and " registers" in line:
            regs = int(line.split("Used ")[1].split()[0])
            rows.append((fn, regs, *spills))
            fn, spills = None, None
    return rows


def phase_build() -> dict:
    t0 = time.perf_counter()
    info = build.build_all()
    _log(f"[build] {sorted(info)} built in {time.perf_counter() - t0:.2f}s")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "build_ptxas.log"), "w") as f:
        for name, i in info.items():
            f.write(f"== {name}\n{i['log']}\n")
    for name, i in info.items():
        _log(f"[build] {name}: nvcc {i['seconds']:.2f}s")
        for line in i["log"].splitlines():
            if "Performance Loss" in line or "setmaxnreg" in line:
                _log(f"[build]   {line.strip()}")
        for fn, regs, stores, loads in _ptxas_report(i["log"]):
            _log(f"[build]   {fn}: {regs} registers, {stores} bytes spill stores, "
                 f"{loads} bytes spill loads")
            if ("wgmma" in fn or "ssd_sm90" in fn or "rglru_scan" in fn
                    or name.startswith("ssd_scan_bwd")) \
                    and (stores or loads):
                _fail(f"instantiation {fn} spills ({stores}/{loads} bytes)")
    if not any("flash_fwd_kernel_wgmmaILi96E" in fn
               for fn, *_ in _ptxas_report(info["flash_attention"]["log"])):
        _fail("flash has no wgmma instantiation at head dim 96")
    want = {hd for hd in fa.HEAD_DIMS if fa.bwd_variant(hd, torch.bfloat16) == "wgmma"}
    for sweep in ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"):
        got = {int(fn.split(f"{sweep}ILi")[1].split("E")[0])
               for fn, *_ in _ptxas_report(info["flash_attention_bwd"]["log"])
               if f"{sweep}ILi" in fn}
        if got != want:
            _fail(f"the flash backward's {sweep} instantiations are at head dims "
                  f"{sorted(got)}, not {sorted(want)}")
    return info


# ==========================================================================
# 2. kernels
# ==========================================================================


def _flash_case(b, l, h, hkv, hd, window, cap, dtype_name, tol) -> None:
    dtype = getattr(torch, dtype_name)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + h)
    out = ops.flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                              block_q=128, block_k=128)
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
    _check(f"flash b={b} l={l} h={h} hkv={hkv} hd={hd} window={window} cap={cap} "
           f"{dtype_name}", out, expect, tol, tol)


def _flash_wgmma_case(b, l, h, hkv, hd, causal, window, cap) -> None:
    q, k, v = _qkv(b, l, h, hkv, hd, torch.bfloat16, seed=l + h + hd)
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                              block_q=l, block_k=l)
    if ops.flash_variant_launches != {**n0, "wgmma": n0["wgmma"] + 1}:
        _fail(f"bf16 hd {hd} did not run the wgmma variant")
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    _check(f"flash wgmma b={b} l={l} h={h} hkv={hkv} hd={hd} causal={causal} "
           f"window={window} cap={cap} bfloat16", out, expect, 2e-2, 2e-2)


def _flash_window_case(b, l, h, hkv, hd, window, dtype_name, tol) -> None:
    """A sliding window without causal masking, as the reference's kernel
    applies it: fp32 on the fma variant, bf16 on wgmma."""
    dtype = getattr(torch, dtype_name)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + hd + window)
    want = "fma" if dtype == torch.float32 else "wgmma"
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=False, window=window, block_q=l, block_k=l)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash {dtype_name} hd {hd} did not run the {want} variant")
    expect = ref.flash_attention_plain(q, k, v, causal=False, window=window)
    _check(f"flash ({want}) non-causal window b={b} l={l} h={h} hkv={hkv} hd={hd} "
           f"window={window} {dtype_name}", out, expect, tol, tol)


def _flash_at(shape, dtype, seed, window: int = 0) -> dict:
    """flash attention at a serving prefill shape (``window`` as a local
    layer passes it), timed against its plain version and the library call
    (causal: a window of at least L does not bind); the work is the
    unmasked causal pairs."""
    b, l, h, hkv, hd = shape
    if window and window < l:
        _fail(f"the library call computes no window: {window} binds at L {l}")
    want = fa.variant(hd, dtype)
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=seed)
    n0 = dict(ops.flash_variant_launches)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              block_q=attention.FLASH_BLOCK, block_k=attention.FLASH_BLOCK)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash at {shape} {dtype} did not run the {want} variant")
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    err = _check(f"flash ({want}) at {shape} {str(dtype)[6:]}", out, expect, tol, tol)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = _row("flash_attention", err,
               lambda: ops.flash_attention(q, k, v, causal=True, window=window,
                                           block_q=attention.FLASH_BLOCK,
                                           block_k=attention.FLASH_BLOCK),
               lambda: ref.flash_attention_ref(q, k, v, causal=True, window=window),
               _nbytes(q, k, v, out), fa.flops(b, l, l, h, hd), dtype,
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               f"q {list(q.shape)}, k/v {list(k.shape)} {str(dtype)[6:]}"
               + (f", window {window}" if window else ""),
               op=lambda: fa.OP(q, k, v, True, window, 0.0, False),
               launch=lambda: fa._launch(q, k, v, True, window, 0.0, False))
    row["variant"], row["source"] = want, FLASH_SOURCES[want]
    return row


def _flash_lse_case(b, l, h, hkv, hd, window, cap, dtype, tol) -> float:
    """The kernel's lse against the plain version's; the output is the same
    as without lse, bit for bit."""
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=l + hd + 3)
    want = fa.variant(hd, dtype)
    kw = dict(causal=True, window=window, softcap=cap, block_q=l, block_k=l)
    n0 = dict(ops.flash_variant_launches)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"flash with lse at hd {hd} {dtype} did not run the {want} variant")
    if not torch.equal(out, ops.flash_attention(q, k, v, **kw)):
        _fail(f"flash ({want}) output changes when lse is stored")
    _, lse_ref = ref.flash_attention_plain_lse(q, k, v, causal=True, window=window,
                                               softcap=cap)
    return _check(f"flash ({want}) lse b={b} l={l} h={h} hkv={hkv} hd={hd} window={window} "
                  f"cap={cap} {str(dtype)[6:]}", lse, lse_ref, tol, tol)


def _flash_train_shape(shape=TRAIN_SHAPE, seed: int = 7, window: int = 0) -> dict:
    """The forward with lse at a training shape, as the training step
    launches it (wgmma, bf16; ``window`` as a local layer passes it),
    timed against its plain version and the library call (causal: a window
    of at least L does not bind); lse [B,H,L] fp32 is one more output."""
    b, l, h, hkv, hd = shape
    if window and window < l:
        _fail(f"the library call computes no window: {window} binds at L {l}")
    q, k, v = _qkv(b, l, h, hkv, hd, torch.bfloat16, seed=seed)
    n0 = dict(ops.flash_variant_launches)
    out, lse = ops.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
    if ops.flash_variant_launches != {**n0, "wgmma": n0["wgmma"] + 1}:
        _fail(f"flash at the training shape {shape} did not run the wgmma variant")
    out_ref, lse_ref = ref.flash_attention_plain_lse(q, k, v, causal=True, window=window)
    err = _check(f"flash (wgmma) at the training shape {list(q.shape)} window {window} "
                 f"bfloat16", out, out_ref, 2e-2, 2e-2)
    lse_err = _check(f"flash (wgmma) lse at the training shape {list(q.shape)}", lse, lse_ref,
                     1e-4, 1e-4)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = _row("flash_attention", err,
               lambda: ops.flash_attention(q, k, v, causal=True, window=window,
                                           return_lse=True),
               lambda: ref.flash_attention_plain_lse(q, k, v, causal=True, window=window),
               _nbytes(q, k, v, out, lse), fa.flops(b, l, l, h, hd), torch.bfloat16,
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               f"q {list(q.shape)}, k/v {list(k.shape)} bfloat16, window {window}, with lse "
               f"[{b},{h},{l}] fp32")
    row["lse_max_abs_err"] = lse_err
    row["variant"], row["source"] = "wgmma", FLASH_SOURCES["wgmma"]
    return row


def phase_flash_lse() -> tuple:
    """lse on both variants: fma on the reference's fp32 cases and at hd 96
    (1e-5), wgmma at hd 64, 96, 128 and 256 (1e-4: its exponentials are
    ex2.approx), the training shape and a rank's shape in the sharded step;
    returns (largest lse error, the two shapes' rows)."""
    errs = [_flash_lse_case(b, l, h, hkv, hd, window, cap, torch.float32, 1e-5)
            for (b, l, h, hkv, hd, window, cap, dt, _) in ref.FLASH_CASES + ref.FLASH_HD96_CASES
            if dt == "float32"]
    for case in ((2, 256, 8, 4, 64, 0, 0.0), (1, 576, 32, 8, 96, 0, 50.0),
                 (1, 576, 32, 4, 128, 0, 50.0), (1, 256, 4, 1, 256, 64, 0.0)):
        errs.append(_flash_lse_case(*case, torch.bfloat16, 1e-4))
    row = _flash_train_shape()
    mesh_row = _flash_train_shape(MESH_TRAIN_SHAPE, seed=8)
    return max(errs + [row["lse_max_abs_err"], mesh_row["lse_max_abs_err"]]), row, mesh_row


def phase_flash() -> dict:
    for case in ref.FLASH_CASES + ref.FLASH_HD256_CASES + ref.FLASH_HD96_CASES:
        _flash_case(*case)
    for case in ref.FLASH_WGMMA_CASES:
        _flash_wgmma_case(*case)
    for case in ref.FLASH_WINDOW_CASES:
        _flash_window_case(*case)
    q, k, v = _qkv(1, 512, 4, 2, 64, torch.float32, seed=0)
    o1 = ops.flash_attention(q, k, v, block_q=64, block_k=128)
    o2 = ops.flash_attention(q, k, v, block_q=256, block_k=64)
    inv = _max_err(o1, o2)
    _log(f"[kernels] flash block-shape invariance max|d|={inv:.3e}")
    if inv > 1e-5:
        _fail("block-shape invariance")
    z = torch.zeros((1, 100, 4, 64), device="cuda")
    try:
        ops.flash_attention(z, z[:, :, :4], z[:, :, :4], block_q=64, block_k=64)
    except ValueError:
        _log("[kernels] flash ragged shape rejected with ValueError")
    else:
        _fail("flash ragged shape was not rejected")
    row = _flash_at(YI_SHAPE, YI.cdtype, seed=1)
    others = [_flash_at(RG_SHAPE, RG.cdtype, seed=2), _flash_at(DS_SHAPE, DS.cdtype, seed=3),
              _flash_at(PHI_SHAPE, PHI.cdtype, seed=4),
              _flash_at(PHI_PREFIX_SHAPE, PHI.cdtype, seed=5),
              _flash_at(YI_SHAPE, torch.float32, seed=1)]    # the FMA variant's time
    if row["variant"] != "wgmma" or any(r["variant"] != "wgmma" for r in others[:4]):
        _fail("a bf16 serving shape does not take the wgmma variant")
    row["at_other_shapes"] = [{k: r[k] for k in (
        "shape", "variant", "source", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "call_ms")} for r in others]
    row["lse_max_err"], train_row, mesh_row = phase_flash_lse()
    for key, r in (("at_train_shape", train_row), ("at_mesh_train_shape", mesh_row)):
        row[key] = {k: r[k] for k in (
            "shape", "max_abs_err", "lse_max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "call_ms", "ms_by_kernel")}
    return row


#: the flash backward's bf16 tolerance (atol = rtol): the wgmma variant
#: rounds p and ds to bf16 once, and its CPU emulation holds the JAX
#: reference's gradients at it (tests/test_torch_flash_attention.py); fp32
#: (fma) 1e-4
FLASH_BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
#: (b, l, h, hkv, hd, dtype, causal, window, softcap) of the backward's
#: checks: the wgmma variant at every head dim it takes, GQA groups 1, 2, 8
#: and 16, L 100 (a ragged last tile) and 192 (head dim 32, which no config
#: trains at, once a mask, its group cycling); the fma variant in fp32 at
#: head dims 8–256, groups 1 and 8, and in bf16 at head dim 8
_BWD_MASKS = ((True, 0, 0.0), (True, 48, 0.0), (False, 48, 0.0), (True, 0, 30.0),
              (False, 0, 0.0))
_BWD_GROUPS = ((4, 4), (8, 4), (16, 2), (16, 1))
FLASH_BWD_CASES = (
    [(1, 100 if hkv == 4 else 192, h, hkv, hd, "bfloat16", *mask)
     for hd in (16, 64, 96, 128, 256) for h, hkv in _BWD_GROUPS for mask in _BWD_MASKS]
    + [(1, 100 if hkv == 4 else 192, h, hkv, 32, "bfloat16", *mask)
       for (h, hkv), mask in zip(_BWD_GROUPS * 2, _BWD_MASKS)]
    + [(2, 100, h, hkv, hd, "float32", *mask) for hd in (8, 16, 64, 96, 128, 256)
       for h, hkv in ((4, 4), (16, 2)) for mask in _BWD_MASKS[1:]]
    + [(2, 100, 4, 2, 8, "bfloat16", *mask) for mask in _BWD_MASKS[::2]])


def _flash_bwd_inputs(b, l, h, hkv, hd, dtype, seed, causal=True, window=0, cap=0.0):
    """q, k, v, the forward kernel's out and lse, and a cotangent do."""
    q, k, v = _qkv(b, l, h, hkv, hd, dtype, seed=seed)
    do = torch.randn((b, l, h, hd), generator=_gen(seed + 1), device="cuda").to(dtype)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                                   block_q=l, block_k=l, return_lse=True)
    return q, k, v, out, lse, do


def _flash_bwd_case(b, l, h, hkv, hd, dtype_name, causal, window, cap) -> float:
    """The backward kernel against the plain backward
    (``models/flash.flash_bwd_plain``, the reference's FA2 in plain PyTorch)
    on the same inputs and lse, dq, dk and dv at FLASH_BWD_TOL; one launch
    of the variant ``bwd_variant`` picks."""
    dtype = getattr(torch, dtype_name)
    args = _flash_bwd_inputs(b, l, h, hkv, hd, dtype, l + h + hd, causal, window, cap)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = fa.bwd_variant(hd, dtype)
    v0 = dict(ops.flash_bwd_variant_launches)
    got = ops.flash_attention_bwd(*args, block_q=l, block_k=l, **kw)
    if ops.flash_bwd_variant_launches != {**v0, want: v0[want] + 1}:
        _fail(f"flash backward {dtype_name} hd {hd} did not launch the {want} variant once")
    plain = flash.flash_bwd_plain(*args, bq=l, bk=l, **kw)
    tol = FLASH_BWD_TOL[dtype]
    return max(_check(f"flash_attention_bwd ({want}) b={b} l={l} h={h} hkv={hkv} hd={hd} "
                      f"causal={causal} window={window} cap={cap} {dtype_name} d{n}", g, w,
                      tol, tol) for n, g, w in zip("qkv", got, plain))


def _flash_bwd_padded(dtype: torch.dtype) -> float:
    """The flash Function through attention._flash_causal at L 100, padded
    to 128 (a multiple of 64): one backward launch, and the real rows'
    gradients against fp32 autograd through the dense plain attention on
    the same inputs (FLASH_BWD_TOL)."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 100, 8, 2, 128, dtype, seed=31))
    do = torch.randn((2, 100, 8, 128), generator=_gen(32), device="cuda").to(dtype)
    want = fa.bwd_variant(128, dtype)
    v0 = dict(ops.flash_bwd_variant_launches)
    attention._flash_causal(q, k, v, window=40, cap=0.0).backward(do)
    if ops.flash_bwd_variant_launches != {**v0, want: v0[want] + 1}:
        _fail(f"the padded flash call in {dtype} did not launch the {want} backward once")
    q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref.flash_attention_ref(q2, k2, v2, causal=True, window=40).backward(do.float())
    tol = FLASH_BWD_TOL[dtype]
    return max(_check(f"flash_attention_bwd ({want}) L 100 padded to 128 {str(dtype)[6:]} "
                      f"d{n}", a.grad, b_.grad, tol, tol)
               for n, a, b_ in (("q", q, q2), ("k", k, k2), ("v", v, v2)))


def _flash_bwd_at(shape, dtype=torch.bfloat16, window: int = 0, seed: int = 33) -> dict:
    """The backward kernel at a training shape (causal, ``window`` as a
    local layer passes it), held against the plain backward and timed
    beside it and beside the library: the backward alone of
    scaled_dot_product_attention(enable_gqa=True) under autograd on the
    same inputs (its device kernels named in library_ms_by_kernel), under
    the boolean causal-and-window mask where the window binds; returns its
    row."""
    b, l, h, hkv, hd = shape
    args = _flash_bwd_inputs(b, l, h, hkv, hd, dtype, seed, window=window)
    q, k, v, out, lse, do = args
    kind = fa.bwd_variant(hd, dtype)
    v0 = dict(ops.flash_bwd_variant_launches)
    got = ops.flash_attention_bwd(*args, window=window)
    if ops.flash_bwd_variant_launches != {**v0, kind: v0[kind] + 1}:
        _fail(f"flash backward at {shape} {dtype} did not run {kind}")
    blk = min(512, l)
    plain = lambda: flash.flash_bwd_plain(*args, causal=True, window=window,  # noqa: E731
                                          softcap=0.0, bq=blk, bk=blk)
    tol = FLASH_BWD_TOL[dtype]
    err = max(_check(f"flash_attention_bwd ({kind}) at {list(q.shape)}/{list(k.shape)} "
                     f"window {window} {str(dtype)[6:]} d{n}", g, w, tol, tol)
              for n, g, w in zip("qkv", got, plain()))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    if not window or window >= l:
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
    else:       # the window binds: the same function under its boolean mask
        mask = attention.make_causal_mask(l, l, window=window, device=q.device)
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,  # noqa: E731
                                          retain_graph=True)
    row = _row("flash_attention_bwd", err, lambda: ops.flash_attention_bwd(*args, window=window),
               plain, _nbytes(*args, *got), fa.bwd_flops(b, l, l, h, hd, window=window), dtype,
               library, f"q/out/do {list(q.shape)}, k/v {list(k.shape)} {str(dtype)[6:]}, "
               f"lse [{b},{h},{l}] fp32" + (f", window {window}" if window else ""),
               op=lambda: fa.BWD_OP(q, k, v, out, lse, do, True, window, 0.0),
               launch=lambda: fa._launch_bwd(q, k, v, out, lse, do, True, window, 0.0),
               plain_calls=3)
    row["variant"], row["source"] = kind, FLASH_BWD_SOURCES[kind]
    return row


def phase_flash_bwd() -> tuple:
    """The flash backward kernel: FLASH_BWD_CASES and the padded call on both
    variants, then timed at yi-9b's training shape (the row), at
    recurrentgemma-9b's (phase 6b: window 2048 at L 4096), at a rank's shape
    of phase 6c in bf16 and in fp32 (its fp32 step) and at the rank's shapes
    of phases 6d, 6e and 6f.  Returns (the row, phase → its entry at a rank's
    shape of that phase, for phase_rank_shapes' table)."""
    errs = [_flash_bwd_case(*case) for case in FLASH_BWD_CASES]
    errs += [_flash_bwd_padded(dtype) for dtype in (torch.float32, torch.bfloat16)]
    row = _flash_bwd_at(TRAIN_SHAPE)
    if row["variant"] != "wgmma":
        _fail("the flash backward at the training shape does not run the wgmma variant")
    row["max_abs_err"] = max(errs + [row["max_abs_err"]])
    others = {"6b recurrentgemma-9b": _flash_bwd_at(
                  (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG.n_heads, RG.n_kv_heads, RG.hd),
                  window=RG.window, seed=34),
              "6c": _flash_bwd_at(MESH_TRAIN_SHAPE, seed=35),
              "6c fp32": _flash_bwd_at(MESH_TRAIN_SHAPE, torch.float32, seed=36),
              "6d": _flash_bwd_at(MESH_REC_FLASH, window=RG.window, seed=37),
              "6e": _flash_bwd_at(MESH_MOE_FLASH, seed=38)}
    for i, (arch, shape) in enumerate(MESH_MM_FLASH.items()):
        others[f"6f {arch}"] = _flash_bwd_at(shape, seed=39 + i)
    keys = SHAPE_KEYS + ("library_ms_by_kernel", "library_null_because", "plain_timed_by")
    entries = {}
    for phase, r in others.items():
        want = "fma" if phase.endswith("fp32") else "wgmma"
        if r["variant"] != want:
            _fail(f"the flash backward at {r['shape']} runs {r['variant']}, not {want}")
        entries[phase] = {"at": f"a shape of phase {phase}", **{k: r[k] for k in keys if k in r}}
    _free()
    return row, entries


def _ssd_inputs(bt, l, h, p, n, dtype, seed, dt0=None):
    """The reference test's recipe, dt = softplus(N(0,1)) and a =
    −exp(linspace(0, 2)); with ``dt0`` the model's, dt = softplus(N(0,1) +
    log(expm1(dt0))) and a = −linspace(1, 16), as ref.SSD_MMA_CASES."""
    g = _gen(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = rnd(bt, l, h, p).to(dtype)
    if dt0 is None:
        dt = torch.nn.functional.softplus(rnd(bt, l, h))
        a = -torch.exp(torch.linspace(0.0, 2.0, h, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(rnd(bt, l, h) + math.log(math.expm1(dt0)))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, rnd(bt, l, n).to(dtype), rnd(bt, l, n).to(dtype)


def _ssd_case(what: str, args, chunk: int, tol: float) -> str:
    """One call with the final state against the plain version: y at
    ``tol``, the state at 2e-4; returns the variant that ran."""
    n0 = dict(ops.ssd_variant_launches)
    y, h_last = ops.ssd_scan(*args, chunk=chunk, return_state=True)
    ran = [k for k in n0 if ops.ssd_variant_launches[k] != n0[k]]
    y_ref, h_ref = ref.ssd_chunked(*args, min(chunk, args[0].shape[1]))
    _check(f"{what} ({'/'.join(ran)})", y, y_ref, tol, tol)
    _check(f"{what} final state", h_last, h_ref, 2e-4, 2e-4)
    return ran[0]


def _ssd_at(dtype: torch.dtype, bt: int = SERVE_BATCH, l: int = SERVE_PROMPT,
            nh: int = 0) -> dict:
    """ssd_scan at a mamba2-370m shape (the prefill's by default: 2 chunks of
    256, so the carry is used; ``nh`` heads, all 32 by default; A =
    −linspace(1, 16), dt = softplus(N(0,1) + dt_bias) as the model's init;
    the chunk min(256, L), as models/ssm takes it), timed against its plain
    version."""
    _, heads, p, n = ssm.dims(MAMBA)
    nh = nh or heads
    q = min(MAMBA.ssm.chunk, l)
    want = ssd.variant(p, n, q, dtype)
    args = _ssd_inputs(bt, l, nh, p, n, dtype, seed=4, dt0=0.01)
    n0 = dict(ops.ssd_variant_launches)
    y, h_last = ops.ssd_scan(*args, chunk=q, return_state=True)
    if ops.ssd_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"ssd_scan at the mamba2-370m shape {dtype} did not run the {want} variant")
    y_ref, h_ref = ref.ssd_chunked(*args, q)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    err = _check(f"ssd_scan ({want}) at the mamba2-370m shape {list(args[0].shape)} "
                 f"{str(dtype)[6:]}", y, y_ref, tol, tol)
    _check(f"ssd_scan ({want}) final state at the mamba2-370m shape", h_last, h_ref,
           2e-4, 2e-4)
    row = _row("ssd_scan", err, lambda: ops.ssd_scan(*args, chunk=q, return_state=True),
               lambda: ref.ssd_chunked(*args, q), _nbytes(*args, y, h_last),
               ssd.flops(bt, l, nh, p, n, q),
               dtype, None, f"x {list(args[0].shape)}, B/C {list(args[3].shape)}, chunk {q} "
               f"{str(dtype)[6:]}", op=lambda: ssd.OP(*args, q, True),
               launch=lambda: ssd._launch_fwd(*args, q, True))
    row["variant"], row["source"] = want, SSD_SOURCES[want]
    row["library_null_because"] = "no PyTorch call computes the chunked SSD scan"
    return row


def phase_ssd() -> dict:
    for (bt, l, h, p, n, chunk, dtype_name, tol) in ref.SSD_CASES:
        args = _ssd_inputs(bt, l, h, p, n, getattr(torch, dtype_name), seed=l + p)
        _ssd_case(f"ssd_scan bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} {dtype_name}",
                  args, chunk, tol)
    for case in ref.SSD_MMA_CASES:
        bt, l, h, p, n, chunk = case
        args = _ssd_inputs(bt, l, h, p, n, torch.bfloat16, seed=l + p, dt0=ref.ssd_dt0(case))
        if case == ref.SSD_STRESS_CASE:
            cum = torch.cumsum((args[1] * args[2]).reshape(bt, l // chunk, chunk, h), dim=2)
            _log(f"[kernels] ssd_scan stress case: min cum in a chunk {float(cum.min()):.1f}")
            if not -200.0 < float(cum.min()) < -100.0:
                _fail("the stress case's cum does not lie between -200 and -100")
        ran = _ssd_case(f"ssd_scan mma case bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} "
                        f"bfloat16 dt0={ref.ssd_dt0(case)}", args, chunk, 5e-2)
        if ran != "mma":
            _fail(f"ssd_scan case {case} ran the {ran} variant, not mma")
    args = _ssd_inputs(1, 256, 2, 16, 32, torch.float32, seed=3)
    _check("ssd_scan chunk invariance (32 vs 128)", ops.ssd_scan(*args, chunk=32),
           ops.ssd_scan(*args, chunk=128), 5e-4, 5e-4)
    try:
        ops.ssd_scan(*(t[:, :100] if t.dim() > 1 else t for t in args), chunk=64)
    except ValueError:
        _log("[kernels] ssd_scan ragged L rejected with ValueError")
    else:
        _fail("ssd_scan ragged L was not rejected")

    row = _ssd_at(MAMBA.cdtype)
    if row["variant"] != "mma":
        _fail("the mamba2-370m serving shape does not take the mma variant")
    other = _ssd_at(torch.float32)                       # the fma variant's time
    row["at_other_shapes"] = [{k: other[k] for k in SHAPE_KEYS}]
    return row


def _rglru_inputs(bt, l, w, dtype, seed):
    g = _gen(seed)
    log_a = -torch.nn.functional.softplus(torch.randn((bt, l, w), generator=g, device="cuda"))
    b = torch.randn((bt, l, w), generator=g, device="cuda").to(dtype).float() * 0.1
    return log_a, b


def _rglru_case(bt, l, w, bl, bw, dtype_name, tol) -> None:
    log_a, b = _rglru_inputs(bt, l, w, getattr(torch, dtype_name), seed=w + l)
    want = rg.variant(w)
    n0 = dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b, block_l=bl, block_w=bw)
    if ops.rglru_variant_launches != {**n0, want: n0[want] + 1}:
        _fail(f"rglru_scan at W={w} did not run the {want} variant")
    _check(f"rglru_scan ({want}) bt={bt} l={l} w={w} bl={bl} bw={bw} {dtype_name}", h,
           ref.rglru_scan_ref(log_a, b), tol, 1e-3)


def _cold_ms(fn, kernel: str) -> float:
    """Device time per call of the device kernels named ``kernel`` with the
    50 MB L2 flushed before each call by writing a 256 MB buffer; the
    flush's own kernel is left out.  Without a split by kernel (see
    _device_profile), the flush's own time is subtracted instead."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def call():
        flush.fill_(1.0)
        fn()
    total, by_kernel = _device_profile(call)
    if by_kernel is None:
        return total - _time_ms(lambda: flush.fill_(1.0))
    return sum(ms for name, ms in by_kernel.items() if kernel in name)


def phase_rglru() -> dict:
    for case in ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES:
        _rglru_case(*case)
    log_a, b = _rglru_inputs(1, 128, 64, torch.float32, seed=0)
    try:
        ops.rglru_scan(log_a[:, :100], b[:, :100], block_l=64, block_w=32)
    except ValueError:
        _log("[kernels] rglru_scan ragged L rejected with ValueError")
    else:
        _fail("rglru_scan ragged L was not rejected")

    # the recurrentgemma-9b prefill shape: 2 of the kernel's 256-step tiles
    log_a, b = _rglru_inputs(SERVE_BATCH, SERVE_PROMPT, rglru.width(RG), torch.float32,
                             seed=5)
    want = rg.variant(log_a.shape[2])
    n0 = dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b)
    if want != "vec4" or ops.rglru_variant_launches != {**n0, "vec4": n0["vec4"] + 1}:
        _fail("the recurrentgemma-9b serving shape does not take the vec4 variant")
    err = _check(f"rglru_scan (vec4) at the recurrentgemma-9b shape {list(log_a.shape)}", h,
                 ref.rglru_scan_ref(log_a, b), 1e-5, 1e-3)
    row = _row("rglru_scan", err, lambda: ops.rglru_scan(log_a, b),
               lambda: ref.rglru_scan_ref(log_a, b), _nbytes(log_a, b, h),
               rg.flops(*log_a.shape), torch.float32, None, f"log_a/b/h {list(log_a.shape)}",
               op=lambda: rg.OP(log_a, b), launch=lambda: rg._launch_fwd(log_a, b))
    row["variant"] = want
    row["ms_cold"] = _cold_ms(lambda: ops.rglru_scan(log_a, b), "rglru_scan_kernel")
    out = torch.empty_like(h)
    row["same_bytes_add_ms"] = _device_ms(lambda: torch.add(log_a, b, out=out))
    _log(f"[kernels] rglru_scan at {row['shape']} with L2 flushed before each call: "
         f"ms_cold={row['ms_cold']:.4f}; torch.add over the same bytes (two reads, "
         f"one write): {row['same_bytes_add_ms']:.4f} ms")
    row["library_null_because"] = ("no PyTorch call computes a first-order linear "
                                   "recurrence")
    return row


# ==========================================================================
# 2b. the scans' backward kernels against autograd of their plain versions
# ==========================================================================


def _rglru_bwd_case(bt, l, w, dtype_name, pad_to=0) -> float:
    """The RG-LRU Function (kernel forward, kernel backward) against autograd
    through the plain version: dlog_a and db at atol = rtol = 1e-4.  With
    ``pad_to`` the call goes through models/rglru._scan, which pads L to a
    multiple of 256 with log_a = 0 (a = 1) and slices the padding off."""
    log_a, b = _rglru_inputs(bt, l, w, getattr(torch, dtype_name), seed=w + l + 1)
    dh = torch.randn((bt, l, w), generator=_gen(w + l + 2), device="cuda")
    want = rg.variant(w)
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    n0, v0 = ops.launches["rglru_scan_bwd"], dict(ops.rglru_bwd_variant_launches)
    h = rglru._scan(la, bb) if pad_to else ops.rglru_scan(la, bb, block_l=l, block_w=w)
    h.backward(dh)
    if (ops.launches["rglru_scan_bwd"] != n0 + 1
            or ops.rglru_bwd_variant_launches != {**v0, want: v0[want] + 1}):
        _fail(f"rglru_scan backward at W={w} did not launch the {want} backward kernel once")
    d_la, d_b = ref.rglru_scan_bwd_plain(log_a, b, dh)
    what = f"rglru_scan_bwd ({want}) bt={bt} l={l}{f' padded to {pad_to}' if pad_to else ''} w={w}"
    return max(_check(f"{what} dlog_a", la.grad, d_la, 1e-4, 1e-4),
               _check(f"{what} db", bb.grad, d_b, 1e-4, 1e-4))


def _check_grad(what: str, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An SSD gradient against the plain version's.  ddt and da are fp32
    sums of many terms: 1e-4 relative, with atol 1e-4 of the tensor's
    largest value (an entry near zero carries the summation order's error at
    the scale of the largest term).  dx, dB, dC: fp32 at atol = rtol = 1e-4;
    bf16 at rtol 1e-2 (one bf16 rounding of the result) and atol 1e-3 of the
    largest value."""
    scale = float(want.float().abs().max())
    if name in ("ddt", "da"):
        return _check(what, got, want, 1e-4 * scale, 1e-4)
    if want.dtype == torch.bfloat16:
        return _check(what, got, want, 1e-3 * scale, 1e-2)
    return _check(what, got, want, 1e-4, 1e-4)


def _ssd_bwd_case(what: str, args, chunk: int, with_state: bool, pad: int = 0) -> float:
    """The SSD Function (kernel forward, kernel backward) against autograd
    through the plain version, with or without a gradient of the final
    state; with ``pad`` rows of zeros appended as models/ssm pads (dt = 0).
    Tolerances as :func:`_check_grad`.  A bf16 case must run the backward's
    mma variant, an fp32 one its fma variant."""
    x = args[0]
    g = _gen(x.shape[1] + x.shape[3] + 7)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    dh = (torch.randn((x.shape[0], x.shape[2], x.shape[3], args[3].shape[-1]), generator=g,
                      device="cuda") if with_state else None)
    leaves = [t.clone().requires_grad_() for t in args]

    def padded(ts):
        if not pad:
            return ts
        return [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if t.dim() > 1
                else t for t in ts]

    n0, v0 = ops.launches["ssd_scan_bwd"], dict(ops.ssd_bwd_variant_launches)
    y, h_last = ops.ssd_scan(*padded(leaves), chunk=chunk, return_state=True)
    outs, cots = [y[:, :x.shape[1]]], [dy]
    if with_state:
        outs.append(h_last)
        cots.append(dh)
    torch.autograd.backward(outs, cots)
    want = "mma" if x.dtype == torch.bfloat16 else "fma"
    if (ops.launches["ssd_scan_bwd"] != n0 + 1
            or ops.ssd_bwd_variant_launches != {**v0, want: v0[want] + 1}):
        _fail(f"{what}: the backward did not launch ssd_scan_bwd ({want}) once")
    what = f"{what} ({want})"
    plain = [t.clone().requires_grad_() for t in args]
    y2, h2 = ref.ssd_chunked(*padded(plain), chunk)
    outs2, cots2 = [y2[:, :x.shape[1]]], [dy]
    if with_state:
        outs2.append(h2)
        cots2.append(dh)
    torch.autograd.backward(outs2, cots2)
    return max(_check_grad(f"{what} {name}", name, a.grad, b.grad)
               for name, a, b in zip(("dx", "ddt", "da", "dB", "dC"), leaves, plain))


def _rglru_bwd_at(bt: int, l: int, w: int) -> dict:
    """rglru_scan_bwd at a training shape [bt, l, w], held against the plain
    version and timed; returns its row."""
    log_a, b = _rglru_inputs(bt, l, w, torch.float32, seed=21)
    h = ops.rglru_scan(log_a, b)
    dh = torch.randn(h.shape, generator=_gen(22), device="cuda")
    v0 = dict(ops.rglru_bwd_variant_launches)
    got = ops.rglru_scan_bwd(log_a, h, dh)
    kind = rg.variant(w)
    if ops.rglru_bwd_variant_launches != {**v0, kind: v0[kind] + 1}:
        _fail(f"rglru_scan_bwd at {list(h.shape)} did not run {kind}")
    want = ref.rglru_scan_bwd_plain(log_a, b, dh)
    err = max(_check(f"rglru_scan_bwd at the training shape {list(h.shape)} {n}", g_, w_,
                     1e-4, 1e-4) for n, g_, w_ in zip(("dlog_a", "db"), got, want))
    row = _row("rglru_scan_bwd", err, lambda: ops.rglru_scan_bwd(log_a, h, dh),
               lambda: ref.rglru_scan_bwd_plain(log_a, b, dh), 5 * _nbytes(h),
               rg.bwd_flops(*h.shape), torch.float32, None,
               f"log_a/h/dh/dlog_a/db {list(h.shape)}", op=lambda: rg.BWD_OP(log_a, h, dh),
               launch=lambda: rg._launch_bwd(log_a, h, dh))
    row["variant"], row["source"] = kind, KERNELS["rglru_scan_bwd"][0]
    row["library_null_because"] = "no PyTorch call computes the recurrence's backward"
    return row


def _ssd_bwd_at(dtype: torch.dtype, bt: int, l: int, nh: int) -> dict:
    """ssd_scan_bwd at a mamba2-370m training shape (``nh`` heads) in
    ``dtype``, held against the plain version and timed; returns its row
    (the mma variant's with the heads a block of its pair passes takes)."""
    _, _, p, n = ssm.dims(MAMBA)
    q = MAMBA.ssm.chunk
    kind = ssd.bwd_variant(p, n, q, dtype)
    x, dt, a, bm, cm = _ssd_inputs(bt, l, nh, p, n, dtype, seed=23, dt0=0.01)
    dy = torch.randn(x.shape, generator=_gen(24), device="cuda").to(x.dtype)
    v0 = dict(ops.ssd_bwd_variant_launches)
    got = ops.ssd_scan_bwd(x, dt, a, bm, cm, q, dy, None)
    if ops.ssd_bwd_variant_launches != {**v0, kind: v0[kind] + 1}:
        _fail(f"ssd_scan_bwd at {list(x.shape)} in {dtype} did not run {kind}")
    want = ref.ssd_scan_bwd_plain(x, dt, a, bm, cm, q, dy)
    err = max(_check_grad(f"ssd_scan_bwd ({kind}) at the training shape {list(x.shape)} "
                          f"{str(dtype)[6:]} {nm}", nm, g_, w_)
              for nm, g_, w_ in zip(("dx", "ddt", "da", "dB", "dC"), got, want))
    del got, want
    row = _row("ssd_scan_bwd", err,
               lambda: ops.ssd_scan_bwd(x, dt, a, bm, cm, q, dy, None),
               lambda: ref.ssd_scan_bwd_plain(x, dt, a, bm, cm, q, dy),
               2 * _nbytes(x, dt, a, bm, cm) + _nbytes(dy),
               ssd.bwd_flops(bt, l, nh, p, n, q), x.dtype, None,
               f"x/dy {list(x.shape)} {str(x.dtype)[6:]}, B/C {list(bm.shape)}, chunk {q}",
               op=lambda: ssd.BWD_OP(x, dt, a, bm, cm, q, dy, None),
               launch=lambda: ssd._launch_bwd(x, dt, a, bm, cm, q, dy, None))
    row["variant"], row["source"] = kind, SSD_BWD_SOURCES[kind]
    if kind == "mma":       # the heads a block of the pair passes takes
        row["heads_per_block"] = ssd.bwd_heads_per_block(nh)
    row["library_null_because"] = "no PyTorch call computes the chunked SSD backward"
    return row


def phase_scan_bwd() -> dict:
    """Both backward kernels on the phase-2 cases, then each timed at its
    training shape; returns their rows."""
    errs = []
    for (bt, l, w, _, _, dtype_name, _) in ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES:
        errs.append(_rglru_bwd_case(bt, l, w, dtype_name))
    errs.append(_rglru_bwd_case(2, 300, 64, "float32", pad_to=512))
    rg_err = max(errs)

    errs = []
    for (bt, l, h, p, n, chunk, dtype_name, _) in ref.SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(bt, l, h, p, n, dtype, seed=l + p)
            for st in (False, True):
                errs.append(_ssd_bwd_case(
                    f"ssd_scan_bwd bt={bt} l={l} h={h} p={p} n={n} chunk={chunk} "
                    f"{str(dtype)[6:]} state grad {st}", args, chunk, st))
    for case in ref.SSD_MMA_CASES:
        bt, l, h, p, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(bt, l, h, p, n, dtype, seed=l + p, dt0=ref.ssd_dt0(case))
            errs.append(_ssd_bwd_case(
                f"ssd_scan_bwd case {case} {str(dtype)[6:]} dt0={ref.ssd_dt0(case)}", args,
                chunk, True))
    args = _ssd_inputs(2, 200, 4, 32, 64, torch.bfloat16, seed=9, dt0=0.01)
    errs.append(_ssd_bwd_case("ssd_scan_bwd L 200 padded to 256 bfloat16", args, 128, True,
                              pad=56))
    ssd_err = max(errs)

    # the training shapes, each timed alone
    rg_row = _rglru_bwd_at(1, RG_TRAIN_SEQ, rglru.width(RG))
    rg_row["max_abs_err"] = max(rg_row["max_abs_err"], rg_err)
    _, nh, _, _ = ssm.dims(MAMBA)
    rows = {}
    for dtype in (torch.float32, MAMBA.cdtype):           # fma first: its line comes earlier
        row = _ssd_bwd_at(dtype, MAMBA_TRAIN_BATCH, TRAIN_SEQ, nh)
        rows[row["variant"]] = row
    ssd_row = rows["mma"]
    ssd_row["max_abs_err"] = max(ssd_row["max_abs_err"], ssd_err)
    ssd_row["at_other_shapes"] = [{k: rows["fma"][k] for k in SHAPE_KEYS}]
    _free()
    return {"ssd_scan_bwd": ssd_row, "rglru_scan_bwd": rg_row}


def _rglru_at(bt: int, l: int, w: int) -> dict:
    """rglru_scan at a training shape [bt, l, w], held against the plain
    version and timed; returns its row."""
    log_a, b = _rglru_inputs(bt, l, w, torch.float32, seed=25)
    kind = rg.variant(w)
    v0 = dict(ops.rglru_variant_launches)
    h = ops.rglru_scan(log_a, b)
    if ops.rglru_variant_launches != {**v0, kind: v0[kind] + 1}:
        _fail(f"rglru_scan at {list(h.shape)} did not run {kind}")
    err = _check(f"rglru_scan ({kind}) at {list(h.shape)}", h, ref.rglru_scan_ref(log_a, b),
                 1e-5, 1e-3)
    row = _row("rglru_scan", err, lambda: ops.rglru_scan(log_a, b),
               lambda: ref.rglru_scan_ref(log_a, b), _nbytes(log_a, b, h),
               rg.flops(*log_a.shape), torch.float32, None, f"log_a/b/h {list(log_a.shape)}")
    row["variant"] = kind
    return row


def phase_rank_shapes() -> dict:
    """Each kernel at a rank's shape in phase 6d's sharded steps
    (MESH_REC_SSD, MESH_REC_RGLRU, MESH_REC_FLASH: bf16, so the mma, vec4
    and wgmma variants), and flash at a rank's shape in phase 6e's
    (MESH_MOE_FLASH), in phase 6f's for each arch (MESH_MM_FLASH), and each
    kernel at a rank's shape in phase 3c's sharded bf16 prefills (yi-9b's,
    recurrentgemma-9b's and seamless-m4t-medium's flash, mamba2-370m's SSD
    scan, recurrentgemma-9b's RG-LRU scan), flash and the RG-LRU scan at
    phase 3d's, the SSD scan and its backward at phase 6g's, and flash and
    the SSD scan at the prefill of phase 5c's decode replicas
    (REMOTE_FLASH; the SSD scan at chunk 64), held against its plain
    version and timed as at its own shape; returns phase (``6f <arch>`` for
    phase 6f, ``3c <arch>`` for phase 3c but yi-9b's ``3c``) → kernel name →
    its entry at that shape (the launches are the phase's, filled in after
    it)."""
    bt, l, hl = MESH_REC_SSD
    rows = {"flash_attention": _flash_train_shape(MESH_REC_FLASH, seed=9, window=RG.window),
            "ssd_scan": _ssd_at(MAMBA.cdtype, bt, l, hl),
            "rglru_scan": _rglru_at(*MESH_REC_RGLRU),
            "ssd_scan_bwd": _ssd_bwd_at(MAMBA.cdtype, bt, l, hl),
            "rglru_scan_bwd": _rglru_bwd_at(*MESH_REC_RGLRU)}
    out = {"6d": {}, "6e": {}}
    for name, row in rows.items():
        if row["variant"] != BF16_VARIANTS[name]:
            _fail(f"{name} at a rank's shape {row['shape']} runs {row['variant']}, not "
                  f"{BF16_VARIANTS[name]}")
        out["6d"][name] = {"at": "a rank's shape in the sharded steps of phase 6d, (2, 2) mesh",
                           **{k: row.get(k) for k in SHAPE_KEYS}}
        if "heads_per_block" in row:
            out["6d"][name]["heads_per_block"] = row["heads_per_block"]
    row = _flash_train_shape(MESH_MOE_FLASH, seed=10)
    out["6e"]["flash_attention"] = {
        "at": "a rank's shape in the sharded MoE steps of phase 6e, (2, 2) mesh",
        **{k: row.get(k) for k in SHAPE_KEYS + ("lse_max_abs_err",)}}
    for i, (arch, shape) in enumerate(MESH_MM_FLASH.items()):
        row = _flash_train_shape(shape, seed=11 + i)
        out[f"6f {arch}"] = {"flash_attention": {
            "at": f"a rank's shape in the sharded {arch} steps of phase 6f, (2, 2) mesh",
            **{k: row.get(k) for k in SHAPE_KEYS + ("lse_max_abs_err",)}}}
    serve = {"3c": {"flash_attention": _flash_at(MESH_SERVE_FLASH, torch.bfloat16, seed=13)},
             "3c mamba2-370m": {"ssd_scan": _ssd_at(MAMBA.cdtype, *MESH_SERVE_SSD)},
             "3c recurrentgemma-9b": {
                 "flash_attention": _flash_at(MESH_SERVE_RG_FLASH, torch.bfloat16, seed=14,
                                              window=RG.window),
                 "rglru_scan": _rglru_at(*MESH_SERVE_RGLRU)},
             "3c seamless-m4t-medium": {
                 "flash_attention": _flash_at(MESH_SERVE_M4T_FLASH, torch.bfloat16, seed=15)}}
    for phase, entries in serve.items():
        arch = phase[3:] or "yi-9b"
        for name, row in entries.items():
            if row["variant"] != BF16_VARIANTS[name]:
                _fail(f"{name} at a rank's shape {row['shape']} of phase 3c runs "
                      f"{row['variant']}, not {BF16_VARIANTS[name]}")
            out.setdefault(phase, {})[name] = {
                "at": f"a rank's shape in the sharded {arch} prefills of phase 3c, (2, 2) mesh",
                **{k: row.get(k) for k in SHAPE_KEYS}}
    # the (1, 3) mesh of phases 3d and 6g: the whole batch, and the heads and
    # widths the model axis of 3 does not divide, whole
    bt, l, nh = MESH3_TRAIN_SSD
    undivided = {
        "3d": ("recurrentgemma-9b's sharded prefills of phase 3d, (1, 3) mesh",
               {"flash_attention": _flash_at(MESH3_SERVE_RG_FLASH, torch.bfloat16, seed=16,
                                             window=RG.window),
                "rglru_scan": _rglru_at(*MESH3_SERVE_RGLRU)}),
        "6g": ("mamba2-370m's sharded steps of phase 6g, (1, 3) mesh",
               {"ssd_scan": _ssd_at(MAMBA.cdtype, bt, l, nh),
                "ssd_scan_bwd": _ssd_bwd_at(MAMBA.cdtype, bt, l, nh)})}
    for phase, (where, entries) in undivided.items():
        for name, row in entries.items():
            if row["variant"] != BF16_VARIANTS[name]:
                _fail(f"{name} at a rank's shape {row['shape']} of phase {phase} runs "
                      f"{row['variant']}, not {BF16_VARIANTS[name]}")
            out.setdefault(phase, {})[name] = {
                "at": f"a rank's shape in {where}", **{k: row.get(k) for k in SHAPE_KEYS}}
            if "heads_per_block" in row:
                out[phase][name]["heads_per_block"] = row["heads_per_block"]
    # the prefill of phase 5c's decode replicas on the RemoteRunner workers:
    # yi-9b's flash (parts a and c) and mamba2-370m's SSD scan at chunk 64 (b)
    remote = {"flash_attention": _flash_at(REMOTE_FLASH, torch.bfloat16, seed=17),
              "ssd_scan": _ssd_at(MAMBA.cdtype, REMOTE_BATCH, REMOTE_PROMPT)}
    for name, row in remote.items():
        if row["variant"] != BF16_VARIANTS[name]:
            _fail(f"{name} at phase 5c's shape {row['shape']} runs {row['variant']}, not "
                  f"{BF16_VARIANTS[name]}")
        out.setdefault("5c", {})[name] = {
            "at": "the prefill of phase 5c's decode replicas, in RemoteRunner workers",
            **{k: row.get(k) for k in SHAPE_KEYS}}
    _free()
    return out


# ==========================================================================
# 3. model: smoke configs, card against CPU
# ==========================================================================


def _model(arch: str, per_prefill: dict, prompt: int = 24) -> None:
    """A smoke config in fp32, card against CPU: prefill logits within 1e-4
    and equal greedy tokens; a VLM with its patch prefix, an enc-dec config
    with prompt // 8 frames."""
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(3)
    params_cpu = lm.init(g, cfg, device="cpu")
    params_gpu = tree_to(params_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, prompt), generator=g)
    modal = {}
    if cfg.n_patches:
        modal["patches"] = torch.randn((2, cfg.n_patches, 1024), generator=g)
    if cfg.frame_input:
        modal["frames"] = torch.randn((2, prompt // 8, 1024), generator=g)
    modal_gpu = tree_to(modal, "cuda")
    max_len = cfg.n_patches + prompt + 16
    _, logits_cpu = lm.prefill(params_cpu, cfg, toks, max_len=max_len, **modal)
    ops.reset_launches()
    _, logits_gpu = lm.prefill(params_gpu, cfg, toks.cuda(), max_len=max_len, **modal_gpu)
    launches = dict(ops.launches)
    if launches != per_prefill:
        _fail(f"{arch} smoke prefill on the card launched {launches}, not {per_prefill}")
    err = _max_err(logits_gpu.cpu(), logits_cpu)
    what = f"{arch} smoke (prompt {prompt}" + "".join(
        f", {k} {list(v.shape)}" for k, v in modal.items()) + ")"
    _log(f"[model] {what} fp32 prefill logits card vs cpu max|d|={err:.3e} "
         f"(tol 1e-4); launches {launches}")
    if not err <= 1e-4:
        _fail(f"{what} card vs cpu prefill logits")
    t_cpu = greedy_generate(params_cpu, cfg, toks, 12, **modal)
    t_gpu = greedy_generate(params_gpu, cfg, toks.cuda(), 12, **modal_gpu).cpu()
    _log(f"[model] {what} greedy tokens equal: {bool(torch.equal(t_cpu, t_gpu))}")
    if not torch.equal(t_cpu, t_gpu):
        _fail(f"{what} card vs cpu greedy tokens differ")


def _expected_launches(cfg) -> dict:
    """Launches of one prefill: one flash per causal self-attention layer of
    the decoder (an enc-dec encoder and the cross-attentions run the dense
    plain attention and launch nothing), one ssd_scan per Mamba2 layer, one
    rglru_scan per RG-LRU layer."""
    kinds = [cfg.pattern_of(i) for i in range(cfg.n_layers)]
    return {"flash_attention": sum(k in ("attn", "local") for k in kinds),
            "ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rglru"),
            "ssd_scan_bwd": 0, "rglru_scan_bwd": 0, "flash_attention_bwd": 0}


def _train_launches(cfg) -> dict:
    """Launches of one training step under remat "dots": every forward
    twice (the recompute runs it again), each backward kernel once a layer
    (the scans' and flash attention's)."""
    once = _expected_launches(cfg)
    return {"flash_attention": 2 * once["flash_attention"], "ssd_scan": 2 * once["ssd_scan"],
            "rglru_scan": 2 * once["rglru_scan"], "ssd_scan_bwd": once["ssd_scan"],
            "rglru_scan_bwd": once["rglru_scan"],
            "flash_attention_bwd": once["flash_attention"]}


def phase_model() -> None:
    for arch in ("yi-9b", "mamba2-370m", "recurrentgemma-9b", "deepseek-moe-16b", "dbrx-132b",
                 "phi-3-vision-4.2b", "seamless-m4t-medium"):
        _model(arch, _expected_launches(configs.get_smoke(arch)))
    # 25 frames: the cross-attention's keys are not a multiple of a 64-row tile
    _model("seamless-m4t-medium", _expected_launches(configs.get_smoke("seamless-m4t-medium")),
           prompt=200)


# ==========================================================================
# 3b. mesh: the distributed branches, 4 gloo ranks sharing the card
# ==========================================================================


def _mesh_decode(params, cfg, toks, cache, ctx, steps: int, greedy: bool):
    """``steps`` decode steps from ``cache`` (under ``ctx``, None: plain);
    greedy feeds each step its own argmax, otherwise the fixed next tokens
    of ``toks`` (the same inputs for both paths).  Returns (logits [steps, B,
    Vp] fp32, host ms per step, each ended by a synchronise)."""
    tok, logits, ms = toks[:, :1], [], []
    with mesh_context(ctx):
        for i in range(steps):
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(params, cfg, tok, cache)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.float())
            tok = lg.argmax(-1)[:, None] if greedy else toks[:, i + 1:i + 2]
    return torch.stack(logits), ms


def _mesh_seqshard(mesh) -> dict:
    """(a) yi-9b at full width, MESH_YI's depth: prefill under the context
    (flash on the card), the cache placed with its slots over the model
    axis, MESH_DECODE steps through ``_decode_seqshard`` against the same
    steps of the plain decode on the unsharded cache: bf16 with the same
    tokens fed to both (logits within 1e-1), fp32 greedy (logits within
    1e-4, equal tokens)."""
    ctx = launch_mesh.make_ctx(mesh, shard_kv_seq=True)
    params = lm.init(_gen(0), MESH_YI)
    toks = torch.randint(0, MESH_YI.vocab, (SERVE_BATCH, SERVE_PROMPT + MESH_DECODE + 1),
                         generator=_gen(1), device="cuda")
    out = {}
    for dtype, tol, greedy in (("bfloat16", 1e-1, False), ("float32", 1e-4, True)):
        cfg = MESH_YI.replace(compute_dtype=dtype)
        ops.reset_launches()
        with mesh_context(ctx):
            cache, _ = lm.prefill(params, cfg, toks[:, :SERVE_PROMPT], max_len=MESH_MAX_LEN)
        torch.cuda.synchronize()
        launches, variants = ops.launches["flash_attention"], dict(ops.flash_variant_launches)
        plain_cache = {**cache, "blocks": _clone_tree(cache["blocks"])}
        seq_cache = distribute_tree(cache, cache_shardings(cache, ctx), ctx)
        del cache
        rest = toks[:, SERVE_PROMPT:]
        mesh_ctx.reset_collective_stats()
        seq, seq_ms = _mesh_decode(params, cfg, rest, seq_cache, ctx, MESH_DECODE, greedy)
        calls = mesh_ctx.collective_stats["calls"]
        plain, plain_ms = _mesh_decode(params, cfg, rest, plain_cache, None, MESH_DECODE,
                                       greedy)
        r = {"flash_launches": launches, "flash_by_variant": variants,
             "max_abs_err": _max_err(seq, plain), "tol": tol,
             "tokens_equal": bool(torch.equal(seq.argmax(-1), plain.argmax(-1))),
             "finite": bool(torch.isfinite(seq).all()), "seq_step_ms": seq_ms,
             "plain_step_ms": plain_ms, "all_reduces": calls,
             "local_ring": list(seq_cache["blocks"]["s0"]["k"].to_local().shape)}
        if dtype == "bfloat16":
            # the same steps again with every all-reduce timed on its own
            mesh_ctx.reset_collective_stats(timed=True)
            _, timed_ms = _mesh_decode(params, cfg, rest, seq_cache, ctx, MESH_DECODE, False)
            r["timed_step_ms"] = timed_ms
            r["all_reduce_s"] = mesh_ctx.collective_stats["seconds"]
            mesh_ctx.reset_collective_stats()
        out[dtype] = r
        del seq_cache, plain_cache
    del params
    _free()
    return out


def _mesh_ep(mesh) -> dict:
    """(b) deepseek-moe-16b at full width, MESH_DS's depth: prefill of
    [4, 512] and MESH_DS_DECODE decode steps (the same tokens on every run)
    under the context, so every MoE layer runs ``apply_ep``; each layer's
    output held against ``apply_ep_emulated`` on the same input, and the
    last logits against a run with every MoE layer emulated.  The emulation
    runs the ranks' own ``moe.ep_partial``; so each layer's input goes
    through ``apply_ep`` once more under ``parallel.ref.no_drop``'s capacity,
    where nothing drops on either path (counted), against ``moe.apply_ref``
    on the card in the rank's process."""
    ctx = launch_mesh.make_ctx(mesh)
    sizes = mesh_ctx.mesh_shape(mesh)
    params = lm.init(_gen(2), MESH_DS)
    toks = torch.randint(0, MESH_DS.vocab, (SERVE_BATCH, SERVE_PROMPT + MESH_DS_DECODE),
                         generator=_gen(3), device="cuda")
    apply = moe.apply
    out = {}
    for dtype, tol in (("bfloat16", 3e-2), ("float32", 1e-5)):
        cfg = MESH_DS.replace(compute_dtype=dtype)

        def run(ctx, layer):
            with mesh_context(ctx), mock.patch.object(moe, "apply", layer):
                cache, lg = lm.prefill(params, cfg, toks[:, :SERVE_PROMPT],
                                       max_len=SERVE_PROMPT + MESH_DS_DECODE)
                logits = [lg.float()]
                for i in range(MESH_DS_DECODE):
                    lg, cache = lm.decode_step(
                        params, cfg, toks[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1], cache)
                    logits.append(lg.float())
            torch.cuda.synchronize()
            return torch.stack(logits)

        calls = []

        def recorded(p, c, x):
            y = apply(p, c, x)
            calls.append((p, x, y))
            return y

        ops.reset_launches()
        mesh_ctx.reset_collective_stats()
        t0 = time.perf_counter()
        logits = run(ctx, recorded)
        wall = time.perf_counter() - t0
        launches, variants = ops.launches["flash_attention"], dict(ops.flash_variant_launches)
        all_reduces = mesh_ctx.collective_stats["calls"]
        layer_err = max(_max_err(y, mesh_ref.apply_ep_emulated(p, cfg, x, sizes))
                        for p, x, y in calls)
        # the independent oracle: every rank runs these all-reduces in one order
        nd = mesh_ref.no_drop(cfg)
        with mesh_context(ctx):
            ref_err = max(_max_err(moe.apply(p, nd, x), moe.apply_ref(p, nd, x))
                          for p, x, _ in calls)
        ref_dropped = sum(mesh_ref.dropped(p, nd, x) + mesh_ref.dropped(p, nd, x, sizes)
                          for p, x, _ in calls)
        shapes = sorted({tuple(x.shape) for _, x, _ in calls})
        n_calls = len(calls)
        calls.clear()
        emulated = run(None, lambda p, c, x: mesh_ref.apply_ep_emulated(p, c, x, sizes))
        out[dtype] = {"flash_launches": launches, "flash_by_variant": variants,
                      "moe_calls": n_calls, "moe_shapes": shapes,
                      "layer_max_abs_err": layer_err,
                      "logits_max_abs_err": _max_err(logits, emulated), "tol": tol,
                      "apply_ref_max_abs_err": ref_err, "apply_ref_dropped": ref_dropped,
                      "no_drop_capacity_prefill": moe.ep_capacity(
                          SERVE_PROMPT * SERVE_BATCH // ctx.batch_size, nd),
                      "finite": bool(torch.isfinite(logits).all()), "all_reduces": all_reduces,
                      "ep_capacity_prefill": moe.ep_capacity(
                          SERVE_PROMPT * SERVE_BATCH // ctx.batch_size, cfg),
                      "run_s": wall}
    del params
    _free()
    return out


def _mesh_rank(rank: int, world: int, directory: str) -> None:
    """One rank of the mesh phase (a ``spawn`` target: the module imports
    without a card and starts no process group).  Loads the kernels the
    parent built, never building one; writes ``<directory>/rank<r>.json``."""
    mesh, r = _rank_mesh(rank, world, directory)
    with torch.no_grad():
        r["seqshard"] = _mesh_seqshard(mesh)
        r["ep"] = _mesh_ep(mesh)
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(r, f)
    dist.destroy_process_group()


def _spawn_ranks(target, timeout: float, world: int = MESH_RANKS) -> tuple:
    """Start ``world`` ``spawn`` processes of ``target(rank, world,
    directory)`` on the card and wait for all: a rank that fails or
    outlasts ``timeout`` fails the run, and the others are killed.  Returns
    (each rank's ``<directory>/rank<r>.json``, seconds)."""
    _free()
    _log(f"[mesh] parent: {torch.cuda.memory_allocated()} B allocated before spawning "
         f"{world} ranks")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    directory = tempfile.mkdtemp(prefix="mesh-", dir=os.path.join(ROOT, "build"))
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=target, args=(r, world, directory)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    while any(p.is_alive() for p in procs) and time.perf_counter() - t0 < timeout:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if codes != [0] * world:
        _fail(f"mesh ranks exited {codes} (None: still running after {timeout} s)")
    ranks = []
    for i in range(world):
        with open(os.path.join(directory, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _rank_mesh(rank: int, world: int, directory: str):
    """This rank's gloo mesh on the card (MESH_SHAPES' of the world: (2,
    2), or (1, 3) on 3 ranks), after checking that the parent built every
    kernel (a rank never builds one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in build.SOURCES if not build._target(n).exists()]
    if missing:
        _fail(f"rank {rank}: kernels {missing} not built by the parent")
    launch_mesh.init_ranks(rank, world, f"file://{directory}/rendezvous")
    mesh = launch_mesh.make_mesh(MESH_SHAPES[world], MESH_AXES)
    r = {"rank": rank, "coord": {a: mesh.get_local_rank(a) for a in MESH_AXES},
         "backend": {a: dist.get_backend(mesh.get_group(a)) for a in MESH_AXES},
         "device": str(torch.device("cuda", torch.cuda.current_device()))}
    if set(r["backend"].values()) != {"gloo"}:
        _fail(f"rank {rank}: mesh groups {r['backend']}, not gloo")
    return mesh, r


def phase_mesh() -> tuple:
    """Spawn MESH_RANKS ranks on the card (:func:`_spawn_ranks`), then check
    and print each rank's results.  Returns (the phase's flash launches as a
    path's launches, by variant, the ranks' results)."""
    ranks, seconds = _spawn_ranks(_mesh_rank, MESH_TIMEOUT)
    _log(f"[mesh] {MESH_RANKS} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH_SHAPE))}, backend {ranks[0]['backend']}, all on "
         f"{ranks[0]['device']}")
    flash = dict.fromkeys(fa.VARIANTS, 0)
    for r in ranks:
        s, e = r["seqshard"], r["ep"]
        _log(f"[mesh] rank {r['rank']} {r['coord']}: peak mem {r['peak_mem_gb']:.2f} GB; flash "
             f"launches (a) {s['bfloat16']['flash_launches']} bf16 "
             f"{s['bfloat16']['flash_by_variant']} + {s['float32']['flash_launches']} fp32, "
             f"(b) {e['bfloat16']['flash_launches']} bf16 + {e['float32']['flash_launches']} "
             f"fp32")
        for dtype, a in s.items():
            _log(f"[mesh]   (a) yi-9b {MESH_YI.n_layers}L seq-sharded decode {dtype}: max|d| "
                 f"{a['max_abs_err']:.3e} vs plain (tol {a['tol']}), tokens equal "
                 f"{a['tokens_equal']}, step ms seq {_ms_list(a['seq_step_ms'])} plain "
                 f"{_ms_list(a['plain_step_ms'])}, {a['all_reduces']} all-reduces, local "
                 f"ring {a['local_ring']}" + (
                     f"; timed pass: {a['all_reduce_s'] * 1e3:.3f} ms in all-reduces over "
                     f"{MESH_DECODE} steps (step ms {_ms_list(a['timed_step_ms'])})"
                     if "all_reduce_s" in a else ""))
            if not (a["max_abs_err"] <= a["tol"] and a["finite"]) or (
                    dtype == "float32" and not a["tokens_equal"]):
                _fail(f"rank {r['rank']} seq-sharded decode {dtype}: {a}")
        for dtype, b in e.items():
            _log(f"[mesh]   (b) deepseek-moe-16b {MESH_DS.n_layers}L apply_ep {dtype}: layer "
                 f"max|d| {b['layer_max_abs_err']:.3e}, logits max|d| "
                 f"{b['logits_max_abs_err']:.3e} vs emulation (tol {b['tol']}), capacity "
                 f"{b['ep_capacity_prefill']}, {b['all_reduces']} all-reduces, moe inputs "
                 f"{b['moe_shapes']}, run {b['run_s']:.3f}s; no-drop capacity "
                 f"{b['no_drop_capacity_prefill']}: layer max|d| "
                 f"{b['apply_ref_max_abs_err']:.3e} vs apply_ref, "
                 f"{b['apply_ref_dropped']} dropped")
            if not (b["layer_max_abs_err"] <= b["tol"] and b["logits_max_abs_err"] <= b["tol"]
                    and b["apply_ref_max_abs_err"] <= b["tol"]
                    and b["apply_ref_dropped"] == 0 and b["finite"]):
                _fail(f"rank {r['rank']} apply_ep {dtype}: {b}")
        want = (MESH_YI.n_layers, MESH_DS.n_layers)
        got = (s["bfloat16"]["flash_by_variant"]["wgmma"], e["bfloat16"]["flash_by_variant"]
               ["wgmma"])
        if got != want:
            _fail(f"rank {r['rank']} bf16 prefills ran {got} wgmma flash launches, not {want}")
        for part in (s, e):
            for a in part.values():
                for v, n in a["flash_by_variant"].items():
                    flash[v] += n
    launches = {**dict.fromkeys(ops.launches, 0), "flash_attention": sum(flash.values())}
    return launches, {"flash_attention": flash, "ssd_scan": dict.fromkeys(ssd.VARIANTS, 0),
                      "rglru_scan": dict.fromkeys(rg.VARIANTS, 0)}, ranks


# ==========================================================================
# 3c, 6c: the dry run's traced rank against the ranks' held steps
# ==========================================================================


def mesh_dryrun_cells(which: str, out: str) -> None:
    """Dry-run the cells of ``MESH_DRYRUN[which]`` on one traced rank of
    their mesh (``MESH_DRYRUN_MESH``: (2, 2) or (1, 3)) and write their
    records to ``out`` (JSON).  Runs in a process of its own
    (:func:`_start_mesh_dryrun`): the traced mesh owns that process's
    default process group while it traces."""
    mesh = MESH_DRYRUN_MESH[which]
    recs = {name: dryrun.run_cell(cfg, spec, mesh=mesh, verbose=False)
            for name, (cfg, spec) in MESH_DRYRUN[which].items()}
    if dist.is_initialized():
        _fail("a traced mesh left its process group behind")
    with open(out, "w") as f:
        json.dump(recs, f)


def _start_mesh_dryrun(which: str) -> tuple:
    """Start :func:`mesh_dryrun_cells` in a subprocess beside the ranks:
    (the process, its output file)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = os.path.join(ROOT, "build", f"mesh_dryrun_{which}.json")
    code = f"import chip_smoke; chip_smoke.mesh_dryrun_cells({which!r}, {out!r})"
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), out


def _mesh_dryrun_records(proc, out: str) -> dict:
    """The records of a :func:`_start_mesh_dryrun` process, once it ends."""
    try:
        _, err = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        _fail(f"the mesh dry run outlasted {MESH_DRYRUN_TIMEOUT} s")
    if proc.returncode:
        _fail(f"the mesh dry run exited {proc.returncode}: {err[-3000:]}")
    with open(out) as f:
        recs = json.load(f)
    os.remove(out)
    if dist.is_initialized():
        _fail("the parent has a default process group after the mesh dry run")
    return recs


def _rank_blocks(tree, inputs: dict) -> int:
    """A rank's bytes of a step's arguments as the dry run places them: the
    local blocks of ``tree``'s tensors (parameters, state, cache) and this
    rank's block of each global input of ``inputs`` (the ambient context's
    batch split)."""
    local = local_batch(inputs, mesh_ctx.current_ctx())
    return (sum(op_cost.storages(tree).values())
            + sum(t.numel() * t.element_size() for t in local.values()))


def _step_memory_start(args, blocks) -> dict:
    """Before a step held against the dry run: the cuBLAS workspaces
    released (the prediction counts the step allocating them), the peak
    reset, and the bytes resident beside the step's arguments ``args``
    (``other``: taken off the measured peak, as :func:`_dryrun_cell` does).
    ``blocks``: :func:`_rank_blocks` of the arguments, or None."""
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - sum(op_cost.storages(args).values())
    torch.cuda.reset_peak_memory_stats()
    return {"blocks": blocks, "other": other}


def _step_memory_end(mem: dict) -> dict:
    torch.cuda.synchronize()
    mem["peak"] = torch.cuda.max_memory_allocated() - mem["other"]
    return mem


def _fp32_state_bytes(cache) -> int:
    """The bytes of a decode cache's fp32 leaves on this rank (the recurrent
    states ``h``, fp32 as the prefill computes them) beyond the 2 a value
    that the dry run's bf16 serving template gives them (ROADMAP Queue 3
    m): the difference between the rank's argument blocks of a decode step
    and the traced rank's argument bytes."""
    return sum(t.numel() * 2 for t in op_cost.tensors({k: v for k, v in cache.items()
                                                      if k != "pos"})
               if t.dtype == torch.float32)


def _hold_against_dryrun(who: str, rec: dict, gloo: dict, launches: dict, mem: dict) -> dict:
    """A rank's held step against the traced rank's record ``rec``: gloo's
    all-reduce calls and bytes equal, each kernel's launches equal to its
    operator calls in the trace, the rank's argument blocks equal to the
    predicted argument bytes (a decode step's fp32 recurrent states taken
    off beyond the bf16 template's: ``fp32_states``), and its peak within
    DRYRUN_RTOL of the predicted one.  Logs the predicted wire bytes beside
    gloo's bytes."""
    c, m = rec["cost"], rec["memory"]
    calls = {k: rec["kernels"].get(op, {}).get("calls", 0) for k, op in DRYRUN_OPS.items()}
    launches = {k: launches.get(k, 0) for k in DRYRUN_OPS}
    rel = (m["peak_bytes"] - mem["peak"]) / mem["peak"]
    out = {"gloo_calls": gloo["calls"], "gloo_bytes": gloo["bytes"],
           "predicted_gloo_calls": c["gloo_calls"], "predicted_gloo_bytes": c["gloo_bytes"],
           "predicted_wire_bytes": c["wire_bytes"], "collective_ops": c["collective_ops"],
           "launches": launches, "operator_calls": calls, "argument_blocks": mem["blocks"],
           "predicted_argument_bytes": m["argument_bytes"], "measured_peak_bytes": mem["peak"],
           "predicted_peak_bytes": m["peak_bytes"], "other_resident_bytes": mem["other"],
           "rel_err": rel, "trace_s": rec["trace_s"]}
    _log(f"[mesh-dryrun] {who}: gloo {gloo['calls']} all-reduces, {gloo['bytes']} B "
         f"(traced rank: {c['gloo_calls']}, {c['gloo_bytes']} B; as collectives "
         f"{c['collective_ops']}, {c['wire_bytes']:.0f} wire bytes by the ring model); "
         f"launches {launches} (operator calls {calls}); argument blocks {mem['blocks']} B "
         f"(predicted {m['argument_bytes']} B; {mem.get('fp32_states', 0)} B of fp32 recurrent "
         f"states beyond the template's bf16); peak {mem['peak']} B measured, "
         f"{m['peak_bytes']} B predicted (rel {rel:+.5f}, limit {DRYRUN_RTOL}; {mem['other']} B "
         f"resident beside the arguments taken off); trace {rec['trace_s']:.2f}s")
    if (gloo["calls"], gloo["bytes"]) != (c["gloo_calls"], c["gloo_bytes"]):
        _fail(f"{who}: gloo {gloo}, the traced rank {c['gloo_calls']} calls, "
              f"{c['gloo_bytes']} B")
    if launches != calls:
        _fail(f"{who}: launches {launches}, the traced rank's operator calls {calls}")
    if mem["blocks"] - mem.get("fp32_states", 0) != m["argument_bytes"]:
        _fail(f"{who}: argument blocks {mem['blocks']} B ({mem.get('fp32_states', 0)} B of "
              f"fp32 recurrent states beyond bf16), predicted {m['argument_bytes']} B")
    if not abs(rel) <= DRYRUN_RTOL:
        _fail(f"{who}: peak {mem['peak']} B, predicted {m['peak_bytes']} B")
    return out


# ==========================================================================
# 3c. mesh serve: prefill and decode on each rank's blocks, 4 gloo ranks
# ==========================================================================


def _mesh_serve_params(arch: str, cfg, gen: torch.Generator) -> dict:
    """``arch``'s weights from its seed's generator ``gen``: bf16 serving
    weights in bf16 compute (dryrun.serve_dtype, as the reference's sharded
    serving cells store them), the fp32 masters in fp32."""
    params = lm.init(gen, cfg, device="cuda")
    return dryrun.serve_dtype(params) if cfg.cdtype == torch.bfloat16 else params


def _mesh_serve_inputs(arch: str) -> tuple:
    """(``arch``'s weights from its seed's generator, then its prompt and a
    VLM's patches or an enc-dec config's SERVE_PROMPT // 8 frames (bf16)
    from the same generator), as the parent draws them; the ranks draw the
    same weights and load the inputs."""
    cfg, seed = MESH_SERVE[arch]
    gen = _gen(seed)
    params = _mesh_serve_params(arch, cfg, gen)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                                      device="cuda", dtype=torch.int32)}
    for key, n in (("patches", cfg.n_patches), ("frames", SERVE_PROMPT // 8 * cfg.enc_dec)):
        if n:
            inputs[key] = torch.randn((SERVE_BATCH, n, 1024), generator=gen,
                                      device="cuda").to(torch.bfloat16)
    return params, inputs


def _max_len(cfg, inputs: dict) -> int:
    return inputs["tokens"].shape[1] + (inputs["patches"].shape[1] if "patches" in inputs
                                        else 0) + MESH_SERVE_DECODE


def _serve_run(params, cfg, inputs: dict, feed=None) -> dict:
    """make_prefill_step, then MESH_SERVE_DECODE make_decode_step steps
    (MESH_SERVE_FP32_DECODE in fp32) under
    the ambient context, each fed ``feed``'s next column (the plain run's
    tokens) or, without it, its own greedy token.  Returns the logits of
    every step [steps + 1, B, Vp] fp32 on the host (joined over the ranks),
    the greedy tokens [B, steps + 1], host ms of the prefill and of each
    decode step (each ended by a synchronise), the prefill's kernel calls
    (flash: q and k shapes; the scans: x's and log_a's), the collectives
    (calls, bytes, host seconds) of the prefill and of each step, each
    step's launches and memory (:func:`_step_memory_start`; on a rank also
    its argument blocks), the expert ids each MoE layer routed its tokens
    to (sorted, on the host, in call order), and the final cache.  Tokens
    are int32, as the dry run's."""
    calls = {"flash_attention": [], "ssd_scan": [], "rglru_scan": []}
    routes, route = [], moe.route

    def recorded(name, shapes):
        kernel = getattr(ops, name)

        def call(*a, **kw):
            calls[name].append(shapes(*a))
            return kernel(*a, **kw)
        return call

    def routed(*a, **kw):
        ids, weights = route(*a, **kw)
        routes.append(torch.sort(ids, dim=-1).values.cpu())
        return ids, weights

    prefill = make_prefill_step(cfg, max_len=_max_len(cfg, inputs))
    decode = make_decode_step(cfg)
    steps = MESH_SERVE_DECODE if cfg.cdtype == torch.bfloat16 else MESH_SERVE_FP32_DECODE
    logits, toks, ms, coll, mem, launched = [], [], [], [], [], []

    def step(fn, args, tree, step_inputs, cache=None):
        mesh_ctx.reset_collective_stats(timed=True)
        on_rank = mesh_ctx.current_ctx() is not None
        m = _step_memory_start(args, _rank_blocks(tree, step_inputs) if on_rank else None)
        if on_rank and cache is not None:
            m["fp32_states"] = _fp32_state_bytes(cache)
        n0 = dict(ops.launches)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        mem.append(_step_memory_end(m))
        launched.append({k: n - n0[k] for k, n in ops.launches.items()})
        coll.append({k: mesh_ctx.collective_stats[k] for k in ("calls", "bytes", "seconds")})
        return out

    with torch.inference_mode(), mock.patch.object(moe, "route", routed):
        with mock.patch.object(ops, "flash_attention", recorded(
                "flash_attention", lambda q, k, *_: [list(q.shape), list(k.shape)])), \
                mock.patch.object(ops, "ssd_scan", recorded("ssd_scan",
                                                            lambda x, *_: list(x.shape))), \
                mock.patch.object(ops, "rglru_scan", recorded("rglru_scan",
                                                              lambda a, *_: list(a.shape))):
            cache, lg = step(prefill, (params, inputs), params, inputs)
        for i in range(steps + 1):
            tok = greedy_token(lg)
            logits.append((gather_rows(lg) if mesh_ctx.is_distributed(lg) else lg).float().cpu())
            toks.append(tok.cpu())
            if i == steps:
                break
            nxt = (tok if feed is None else feed[:, i:i + 1].to(tok.device)).to(torch.int32)
            lg, cache = step(decode, (params, nxt, cache), (params, cache), {"token": nxt},
                             cache)
    mesh_ctx.reset_collective_stats()
    return {"logits": torch.stack(logits), "tokens": torch.cat(toks, dim=1),
            "prefill_ms": ms[0], "decode_ms": ms[1:], "kernel_calls": calls,
            "prefill_collectives": coll[0], "decode_collectives": coll[1:], "cache": cache,
            "routes": routes, "memory": mem, "step_launches": launched}


def _mesh_serve_refs() -> None:
    """The plain prefill and decode each case is held against, on the card
    before the ranks start: per arch, the bf16 run (its own greedy tokens)
    and the one-layer fp32 run, on the weights and inputs every rank draws
    from the seed.  Writes the inputs, tokens and logits for the ranks."""
    refs = {}
    for arch, (cfg, _) in MESH_SERVE.items():
        _free()
        params, inputs = _mesh_serve_inputs(arch)
        bf16 = _serve_run(params, cfg, inputs)
        del params
        _free()
        f32 = MESH_SERVE_FP32[arch]
        params = _mesh_serve_params(arch, f32, _gen(MESH_SERVE[arch][1]))
        fp32 = _serve_run(params, f32, inputs)
        del params
        _free()
        refs[arch] = {"inputs": {k: v.cpu() for k, v in inputs.items()},
                      **{d: {"logits": r["logits"], "tokens": r["tokens"],
                             "routes": r["routes"], "prefill_ms": r["prefill_ms"],
                             "decode_ms": r["decode_ms"]}
                         for d, r in (("bfloat16", bf16), ("float32", fp32))}}
        _log(f"[mesh-serve] plain references, {arch}: width {cfg.d_model}, {cfg.n_layers} "
             f"layers, inputs { {k: list(v.shape) for k, v in inputs.items()} }: bf16 prefill "
             f"{bf16['prefill_ms']:.1f} ms, decode ms {_ms_list(bf16['decode_ms'])}; fp32 "
             f"{f32.n_layers}-layer prefill {fp32['prefill_ms']:.1f} ms")
    torch.save(refs, MESH_SERVE_REFS)


def _rank_block(n: int, m: int) -> int:
    """A rank's share of a dim the rule table splits over a model axis of
    ``m``: its block where ``m`` divides the dim, else the whole dim (the
    table's guard leaves it whole)."""
    return n // m if n % m == 0 else n


def _rank_kernel_calls(cfg, shape=MESH_SHAPE) -> dict:
    """Each kernel's calls in a sharded prefill of phase 3c or 3d on a rank
    of a (data, model) mesh of ``shape``, as :func:`_serve_run` records
    them: flash [q shape, k shape] a causal self-attention layer (its batch
    block, the prompt (a VLM's patches first) padded to a multiple of
    attention.FLASH_BLOCK, its q heads (:func:`_rank_block`) and the kv
    heads they read: its block of them where the model axis divides them,
    else the one a GQA group of its q heads reads, or all of them), the SSD
    scan's x [B_loc, L, H/model or H, P] an SSM layer, the RG-LRU scan's
    log_a [B_loc, L, W/model or W] an RG-LRU layer."""
    b, m = SERVE_BATCH // shape[0], shape[1]
    lp = -(-(SERVE_PROMPT + cfg.n_patches) // attention.FLASH_BLOCK) * attention.FLASH_BLOCK
    kinds = [cfg.pattern_of(i) for i in range(cfg.n_layers)]
    hl = _rank_block(cfg.n_heads, m)
    kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0
          else max(1, hl // (cfg.n_heads // cfg.n_kv_heads)))
    out = {"flash_attention": [[[b, lp, hl, cfg.hd], [b, lp, kv, cfg.hd]]] * sum(
        k in ("attn", "local") for k in kinds), "ssd_scan": [], "rglru_scan": []}
    if cfg.ssm is not None:
        _, nh, p, _ = ssm.dims(cfg)
        out["ssd_scan"] = [[b, SERVE_PROMPT, _rank_block(nh, m), p]] * kinds.count("ssm")
    if cfg.rglru is not None:
        out["rglru_scan"] = [[b, SERVE_PROMPT, _rank_block(rglru.width(cfg), m)]] * \
            kinds.count("rglru")
    return out


def _cache_share(cache, ctx) -> tuple:
    """(this rank's cache bytes, the rule table's share of the global
    cache: each ring's global bytes over the sizes of the axes its spec
    shards it on)."""
    rings = [t for t in tree_leaves({k: v for k, v in cache.items() if k != "pos"})]
    local = sum(t.to_local().numel() * t.to_local().element_size() for t in rings)
    share = 0
    for t in rings:
        n = 1
        for e in spec_of(t):
            n *= mesh_ctx.axes_size(ctx, e)
        share += t.numel() * t.element_size() // n
    return local, share


def _rule_share(state, ctx) -> int:
    """The rule table's share of a sharded state's DTensors on a rank: each
    leaf's global bytes over the sizes of the axes ``param_shardings``
    shards it on, a leaf its guard leaves whole over the model axis
    counted whole."""
    return sum(t.numel() * t.element_size() // math.prod(mesh_ctx.axes_size(ctx, e)
                                                         for e in spec)
               for t, spec in zip(tree_leaves(state), tree_leaves(param_shardings(state, ctx)))
               if mesh_ctx.is_distributed(t))


def _route_agreement(mine: list, plain: list, n_layers: int, rows: slice) -> tuple:
    """The MoE layers' routing on this rank (its batch block ``rows`` of
    each call's tokens) against the plain run's: per step and batch row,
    whether the step's token (the prefill's last position, a decode step's
    token) went to the same experts in every layer [steps, B_loc]; and the
    rank's tokens routed to another set of experts in any layer call, of
    all it routed."""
    agree, moved, total = [], 0, 0
    for step in range(len(mine) // n_layers):
        ok = None
        for layer in range(n_layers):
            a = mine[step * n_layers + layer]
            a = a.reshape(rows.stop - rows.start, -1, a.shape[-1])
            b = plain[step * n_layers + layer].reshape(-1, a.shape[1], a.shape[-1])[rows]
            other = (a != b).any(dim=-1)                      # [B_loc, tokens]
            moved, total = moved + int(other.sum()), total + other.numel()
            ok = ~other[:, -1] if ok is None else ok & ~other[:, -1]
        agree.append(ok)
    return torch.stack(agree), moved, total


def _mesh_serve_case(mesh, arch: str, knobs: dict, refs: dict) -> dict:
    """One case of phase 3c on this rank: the arch's weights from its seed
    placed by the rule table (this rank's blocks kept), the bf16 run fed the
    plain tokens, then the one-layer fp32 run greedy, each against the
    parent's plain run.  An MoE arch's logits are held where the step's
    token went to the same experts as in the plain run, and every call of
    its layers on the rank's blocks against moe.apply_ref on the same input
    with the global weights, which the rank keeps for it."""
    cfg, seed = MESH_SERVE[arch]
    ctx = launch_mesh.make_ctx(mesh, **knobs)
    inputs = tree_to(refs[arch]["inputs"], "cuda")
    out = {}
    for dtype, c in (("bfloat16", cfg), ("float32", MESH_SERVE_FP32[arch])):
        params = _mesh_serve_params(arch, c, _gen(seed))
        layers, calls, blocks = [], [], moe.apply_blocks
        if c.moe is not None:       # one stacked slot of attention layers, as deepseek-moe-16b
            layers = [lm._index(params["blocks"]["s0"]["moe"], i) for i in range(c.n_layers)]

        def recorded(p, cf, x, cx):
            y = blocks(p, cf, x, cx)
            calls.append((x, y))
            return y

        params = distribute_tree(params, param_shardings(params, ctx), ctx)
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = refs[arch][dtype]
        v0 = _variant_launches()
        with mesh_context(ctx), mock.patch.object(moe, "apply_blocks", recorded):
            r = _serve_run(params, c, inputs, want["tokens"] if dtype == "bfloat16" else None)
        variants = {k: {v: n - v0[k][v] for v, n in counts.items()}
                    for k, counts in _variant_launches().items() if k in r["kernel_calls"]}
        ltol, layer_err, layer_close = MESH_SERVE_LAYER_TOL[dtype], 0.0, True
        with torch.inference_mode():
            for i, (x, y) in enumerate(calls):
                y_ref = moe.apply_ref(layers[i % c.n_layers], c, x)
                layer_err = max(layer_err, _max_err(y, y_ref))
                layer_close &= torch.allclose(y.float(), y_ref.float(), atol=ltol, rtol=ltol)
        del layers, calls
        local, share = _cache_share(r.pop("cache"), ctx)
        got = r.pop("logits")
        err = (got - want["logits"]).abs().amax(dim=-1)              # [steps, B]
        route = {}
        if c.moe is not None:
            b_loc = SERVE_BATCH // ctx.batch_size
            b0 = ctx.linear_coord(tuple(ctx.batch_axes)) * b_loc
            rows = slice(b0, b0 + b_loc)
            agree, moved, total = _route_agreement(r["routes"], want["routes"], c.n_layers,
                                                   rows)
            err = err[:, rows]
            route = {"rerouted_tokens": moved, "routed_tokens": total,
                     "rows_rerouted": int((~agree).sum()), "layer_max_abs_err": layer_err,
                     "layer_allclose": layer_close,
                     "max_abs_err_rerouted": float(err[~agree].max()) if (~agree).any()
                     else 0.0}
            err = err[agree]
        r.pop("routes")
        out[dtype] = {**{k: v for k, v in r.items() if k != "tokens"}, **route,
                      "max_abs_err": float(err.max()) if err.numel() else 0.0,
                      "tokens_equal": bool(torch.equal(r["tokens"], want["tokens"])),
                      "finite": bool(torch.isfinite(got).all()),
                      "by_variant": variants, "cache_bytes": local,
                      "cache_share": share, "n_layers": c.n_layers,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params
        _free()
    return out


def _mesh_serve_rank(rank: int, world: int, directory: str) -> None:
    """One rank of phase 3c (every case of MESH_SERVE_CASES) or, on
    MESH3_RANKS ranks, of phase 3d (MESH3_SERVE_CASES).  Writes
    ``<directory>/rank<r>.json``."""
    mesh, r = _rank_mesh(rank, world, directory)
    refs = torch.load(MESH_SERVE_REFS)
    cases = MESH_SERVE_CASES if world == MESH_RANKS else MESH3_SERVE_CASES
    r["cases"] = [_mesh_serve_case(mesh, arch, knobs, refs) for arch, knobs in cases]
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(r, f)
    dist.destroy_process_group()


def _check_serve_ranks(phase: str, ranks: list, cases: tuple, shape: tuple, traced: dict,
                       dry_arch: str) -> tuple:
    """The ranks' records of phase 3c or 3d (``cases`` on a mesh of
    ``shape``), each case printed and checked as :func:`phase_mesh_serve`
    says, ``dry_arch``'s bf16 prefill and first decode step on every rank
    held against the traced rank's records ``traced``.  Returns (the
    launches by variant, each bf16 arch's launches at its rank shapes keyed
    as phase_rank_shapes keys them, each held step)."""
    kernels = ("flash_attention", "ssd_scan", "rglru_scan")
    by_variant = {k: dict.fromkeys(v, 0) for k, v in _variant_launches().items()}
    at_rank, held = {}, {}
    for r in ranks:
        for (arch, knobs), case in zip(cases, r["cases"], strict=True):
            cfg = MESH_SERVE[arch][0]
            who = f"rank {r['rank']} {r['coord']} {arch}" + (f" {knobs}" if knobs else "")
            for dtype, a in case.items():
                tol = MESH_SERVE_BF16_TOL if dtype == "bfloat16" else MESH_SERVE_FP32_TOL
                pre, dec = a["prefill_collectives"], a["decode_collectives"]
                calls = {k: sorted({str(c) for c in v}) for k, v in a["kernel_calls"].items()
                         if v}
                _log(f"[mesh-serve] {who} {dtype} ({a['n_layers']} layers): max|d| "
                     f"{a['max_abs_err']:.3e} vs plain (tol {tol}), "
                     f"tokens equal {a['tokens_equal']}; prefill {a['prefill_ms']:.1f} ms "
                     f"({pre['calls']} all-reduces, {pre['bytes'] / 1e9:.3f} GB, "
                     f"{pre['seconds']:.3f} s), decode ms {_ms_list(a['decode_ms'])} "
                     f"({dec[-1]['calls']} all-reduces a step, {dec[-1]['bytes'] / 1e9:.3f} GB, "
                     f"{_ms_list([d['seconds'] * 1e3 for d in dec])} ms in them); cache "
                     f"{a['cache_bytes']} B (the rule table's share {a['cache_share']} B); "
                     f"peak {a['peak_mem_gb']:.2f} GB; kernels {a['by_variant']} at {calls}")
                if (arch, knobs, dtype) == (dry_arch, {}, "bfloat16"):
                    for i, (name, gloo) in enumerate((("prefill", a["prefill_collectives"]),
                                                      ("decode", a["decode_collectives"][0]))):
                        held[f"rank {r['rank']} {name}"] = _hold_against_dryrun(
                            f"{who} {dtype} {name}", traced[name], gloo,
                            a["step_launches"][i], a["memory"][i])
                if "routed_tokens" in a:
                    ltol = MESH_SERVE_LAYER_TOL[dtype]
                    _log(f"[mesh-serve] {who} {dtype} MoE: every layer call on the rank's "
                         f"blocks against moe.apply_ref on its input, max|d| "
                         f"{a['layer_max_abs_err']:.3e} (allclose at atol = rtol = {ltol}: "
                         f"{a['layer_allclose']}); {a['rerouted_tokens']} of "
                         f"the rank's {a['routed_tokens']} tokens went to other experts than in "
                         f"the plain run, {a['rows_rerouted']} (step, row) logits whose own "
                         f"token did are not held (max|d| there "
                         f"{a['max_abs_err_rerouted']:.3e})")
                    if not a["layer_allclose"] or (dtype == "float32" and a["rerouted_tokens"]):
                        _fail(f"{who} {dtype}: MoE layers {a['layer_max_abs_err']} from "
                              f"apply_ref, {a['rerouted_tokens']} tokens routed otherwise")
                if not (a["max_abs_err"] <= tol and a["finite"]) or (
                        dtype == "float32" and not a["tokens_equal"]):
                    _fail(f"{who} sharded serving {dtype}: {a}")
                if a["cache_bytes"] != a["cache_share"]:
                    _fail(f"{who} {dtype}: cache bytes {a['cache_bytes']}, not the rule "
                          f"table's share {a['cache_share']}")
                c = cfg if dtype == "bfloat16" else MESH_SERVE_FP32[arch]
                named = BF16_VARIANTS if dtype == "bfloat16" else FP32_VARIANTS
                launches = _expected_launches(c)
                want = {k: {**dict.fromkeys(by_variant[k], 0), named[k]: launches[k]}
                        for k in kernels}
                want_calls = _rank_kernel_calls(c, shape)
                if a["by_variant"] != want or a["kernel_calls"] != want_calls:
                    _fail(f"{who} {dtype}: the prefill launched {a['by_variant']} at "
                          f"{a['kernel_calls']}, not {want} at {want_calls}")
                for k, counts in a["by_variant"].items():
                    for v, n in counts.items():
                        by_variant[k][v] += n
                if dtype == "bfloat16":
                    key = phase if arch == dry_arch else f"{phase} {arch}"
                    for k in kernels:
                        at_rank.setdefault(key, dict.fromkeys(ops.launches, 0))[k] += \
                            launches[k]
    if len(held) != 2 * len(ranks):
        _fail(f"held {sorted(held)} against the dry run, not every rank's prefill and decode")
    return by_variant, at_rank, held


def phase_mesh_serve() -> tuple:
    """Phase 3c: the parent's plain references (:func:`_mesh_serve_refs`,
    left on disk for phase 3d), then the MESH_RANKS ranks; fails unless
    every case's bf16 logits are within MESH_SERVE_BF16_TOL and its fp32
    logits within MESH_SERVE_FP32_TOL of the plain run's with equal greedy
    tokens, every rank's cache bytes are the rule table's share, and every
    prefill launched each kernel once a layer of its kind (flash a causal
    self-attention layer, the SSD scan an SSM layer, the RG-LRU scan an
    RG-LRU layer) on the variant of its dtype at the rank's shape
    (:func:`_rank_kernel_calls`), and yi-9b's bf16 prefill and first decode
    step on every rank match the dry run of one traced rank of the mesh
    (:func:`_hold_against_dryrun`).  Returns (the ranks' launches as a
    path's, by variant, the launches of each bf16 arch at its rank shapes,
    keyed as phase_rank_shapes keys them, the ranks' records, each held
    step against the dry run)."""
    t0 = time.perf_counter()
    dry = _start_mesh_dryrun("serve")
    _mesh_serve_refs()
    ranks, seconds = _spawn_ranks(_mesh_serve_rank, MESH_TIMEOUT)
    traced = _mesh_dryrun_records(*dry)
    _log(f"[mesh-serve] {MESH_RANKS} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH_SHAPE))}, batch {SERVE_BATCH} x {SERVE_PROMPT}, "
         f"{MESH_SERVE_DECODE} decode steps ({MESH_SERVE_FP32_DECODE} in fp32); gloo moves "
         f"every gather and sum through host memory, so these times describe this harness, "
         f"not a cluster")
    by_variant, at_rank, held = _check_serve_ranks("3c", ranks, MESH_SERVE_CASES, MESH_SHAPE,
                                                   traced, "yi-9b")
    _log(f"[mesh-serve] phase took {time.perf_counter() - t0:.1f}s")
    launches = {k: sum(v.values()) for k, v in by_variant.items()}
    return launches, by_variant, at_rank, ranks, held


def phase_mesh_serve_undivided() -> tuple:
    """Phase 3d: the MESH3_RANKS ranks as the (1, 3) mesh serve
    MESH3_SERVE_CASES against phase 3c's plain references (which it then
    removes), checked as phase 3c's (:func:`_check_serve_ranks`): the rank
    shapes are the whole ones where the model axis does not divide the
    dim, and recurrentgemma-9b's bf16 prefill and first decode step are
    held against a traced rank of the (1, 3) mesh.  Returns as
    :func:`phase_mesh_serve`."""
    t0 = time.perf_counter()
    dry = _start_mesh_dryrun("serve3")
    ranks, seconds = _spawn_ranks(_mesh_serve_rank, MESH_TIMEOUT, MESH3_RANKS)
    os.remove(MESH_SERVE_REFS)
    traced = _mesh_dryrun_records(*dry)
    _log(f"[mesh-serve3] {MESH3_RANKS} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH3_SHAPE))}, batch {SERVE_BATCH} x {SERVE_PROMPT}, "
         f"{MESH_SERVE_DECODE} decode steps ({MESH_SERVE_FP32_DECODE} in fp32); the rule "
         f"table's guard leaves whole what a model axis of 3 does not divide")
    by_variant, at_rank, held = _check_serve_ranks(
        "3d", ranks, MESH3_SERVE_CASES, MESH3_SHAPE, traced, MESH3_SERVE_CASES[0][0])
    _log(f"[mesh-serve3] phase took {time.perf_counter() - t0:.1f}s")
    launches = {k: sum(v.values()) for k, v in by_variant.items()}
    return launches, by_variant, at_rank, ranks, held


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _ms_list(ms) -> str:
    return "[" + ", ".join(f"{m:.3f}" for m in ms) + "]"


# ==========================================================================
# 4. serve and 5. workflow at full width
# ==========================================================================


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(arch: str) -> dict:
    cfg = configs.get(arch)
    want = _expected_launches(cfg)
    ops.reset_launches()
    r = launch_serve.run(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, seed=0, device="cuda")
    launches = dict(ops.launches)
    toks = r["tokens"]
    _log(f"[serve] {arch} full width ({cfg.n_layers}L d{cfg.d_model}): init "
         f"{r['init_s']:.2f}s, prefill {r['prefill_ms']:.3f} ms, decode "
         f"{r['decode_ms_per_token']:.3f} ms/token, {r['tok_s']:.2f} tok/s, peak mem "
         f"{r['peak_mem_gb']:.2f} GB, launches {launches}")
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN):
        _fail(f"{arch} generated shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        _fail(f"{arch} generated ids out of range")
    if launches != want or r["launches"] != want or not any(want.values()):
        _fail(f"{arch} launches {launches} != {want} per prefill")
    variants = {"flash_attention": dict(ops.flash_variant_launches),
                "ssd_scan": dict(ops.ssd_variant_launches),
                "rglru_scan": dict(ops.rglru_variant_launches)}
    if variants["flash_attention"] != {**dict.fromkeys(fa.VARIANTS, 0),
                                       "wgmma": want["flash_attention"]}:
        _fail(f"{arch} flash launches by variant {variants['flash_attention']}: not all wgmma")
    if variants["ssd_scan"] != {**dict.fromkeys(ssd.VARIANTS, 0), "mma": want["ssd_scan"]}:
        _fail(f"{arch} ssd_scan launches by variant {variants['ssd_scan']}: not all mma")
    if variants["rglru_scan"] != {**dict.fromkeys(rg.VARIANTS, 0),
                                  "vec4": want["rglru_scan"]}:
        _fail(f"{arch} rglru_scan launches by variant {variants['rglru_scan']}: "
              "not all vec4")
    _log(f"[serve] {arch} launches by variant {variants}")
    del r, toks
    _free()
    return launches, variants


def phase_vlm_prefix() -> tuple:
    """phi-3-vision-4.2b at full width and depth through the engine's step
    functions with its 576-patch prefix: one prefill of [4, 512] tokens and
    [4, 576, 1024] bf16 patches (L = 1088, no padding), then 31 decode steps.
    Returns (launches, flash launches by variant, measurements)."""
    cfg = PHI
    gen = _gen(0)
    params = lm.init(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                           device="cuda")
    patches = torch.randn((SERVE_BATCH, cfg.n_patches, 1024), generator=gen,
                          device="cuda").to(torch.bfloat16)
    l = cfg.n_patches + SERVE_PROMPT
    prefill = make_prefill_step(cfg, max_len=l + SERVE_GEN)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache, logits = prefill(params, {"tokens": tokens, "patches": patches})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pos = cache["pos"]
        launches = dict(ops.launches)
        variants = dict(ops.flash_variant_launches)
        toks = [logits.argmax(-1)[:, None]]
        finite = bool(torch.isfinite(logits).all())
        for _ in range(SERVE_GEN - 1):
            logits, cache = decode(params, toks[-1], cache)
            toks.append(logits.argmax(-1)[:, None])
        finite = finite and bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out = torch.cat(toks, dim=1)
    r = {"prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_token": (t2 - t1) * 1e3 / (SERVE_GEN - 1),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "pos_after_prefill": pos,
         "L": l}
    _log(f"[prefix] phi-3-vision-4.2b full width ({cfg.n_layers}L d{cfg.d_model}), patches "
         f"{list(patches.shape)} bf16 + tokens {list(tokens.shape)}: prefill "
         f"{r['prefill_ms']:.3f} ms (L {l}), decode {r['decode_ms_per_token']:.3f} ms/token, "
         f"peak mem {r['peak_mem_gb']:.2f} GB, cache pos {pos}, prefill launches {launches}, "
         f"flash by variant {variants}")
    want = _expected_launches(cfg)
    if launches != want or variants != {**dict.fromkeys(fa.VARIANTS, 0),
                                        "wgmma": want["flash_attention"]}:
        _fail(f"phi-3-vision-4.2b prefix prefill launched {launches} ({variants}), not {want} "
              "all wgmma")
    if pos != l:
        _fail(f"phi-3-vision-4.2b cache pos {pos} after the prefill, not {l}")
    if not finite or tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or int(out.max()) >= \
            cfg.padded_vocab or int(out.min()) < 0:
        _fail("phi-3-vision-4.2b prefix run gave non-finite logits or ids out of range")
    del params, cache, logits, patches
    _free()
    return launches, {"flash_attention": variants, "ssd_scan": dict.fromkeys(ssd.VARIANTS, 0),
                      "rglru_scan": dict.fromkeys(rg.VARIANTS, 0)}, r


def phase_workflow(arch: str) -> None:
    cfg = configs.get(arch)
    per_prefill = _expected_launches(cfg)
    params = lm.init(_gen(1), cfg, device="cuda")
    ops.reset_launches()
    out = workflow.run(params, cfg, batch=2, prompt_len=16, steps=12)
    launches = dict(ops.launches)
    _log(f"[workflow] {arch}: {out['completions']} detok completion(s) in "
         f"{out['wall_s']:.2f}s; {out['decode_calls']} decode executions in the records, "
         f"{out['decode_runs']} ran the model; launches {launches}")
    if out["completions"] != 1:
        _fail(f"{arch} serve workflow did not complete exactly once")
    want = {k: n * out["decode_runs"] for k, n in per_prefill.items()}
    if launches != want:
        _fail(f"{arch} workflow launches {launches} != {per_prefill} per decode replica")
    prompt = torch.tensor(workflow.prompt_ids(cfg, 2, 16, 7), device="cuda")
    direct = greedy_generate(params, cfg, prompt, 12).cpu().tolist()
    if direct != out["ids"]:
        _fail(f"{arch} workflow tokens differ from a direct greedy_generate call")
    _log(f"[workflow] {arch} committed tokens equal a direct greedy_generate call")
    del params
    _free()


# ==========================================================================
# 5c. remote workflow: the serve workflow on forked RemoteRunner workers
# ==========================================================================


def _append_line(path: str, entry: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def _lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def remote_policy(log: str, kill: bool):
    """Phase 5c's crash policy, which the remote tests' coordinator
    (tests/torch_remote_worker.py) uses too; it runs in the workers.  Logs
    each attempt's first effect ("claim") and its output commit ("commit"):
    the pid, function, faas, attempt and whether CUDA is initialised in that
    process.  A decode's commit follows its model run at once
    (core/orchestrator.handle), so its line also holds that run's kernel
    launches by variant (counted from 0: a worker is forked from a
    coordinator that launched nothing, and the counters are reset after each
    line), the process's peak ``max_memory_allocated`` and the milliseconds
    the policy took to build the line (its write to the file left out).
    The model run ends in a copy to the host, so nothing here waits for the
    card.  With ``kill``, the first aws/lambda decode attempt to reach its
    commit is SIGKILLed there after its line ("kill": a real kill -9 of the
    worker process, armed once through chaos_once)."""
    def policy(ex, effect):
        t0 = time.perf_counter()
        rec = ex.record
        commit = type(effect) is shim.DsCreate and effect.key.endswith("-output")
        if not (commit or ex.effect_index == 0):
            return False
        fire = (kill and commit and rec.function == "decode" and rec.faas == workflow.PRIMARY
                and ex.runner.chaos_once("kill-primary-decode"))
        cuda = torch.cuda.is_initialized()
        entry = {"event": "kill" if fire else "commit" if commit else "claim",
                 "pid": os.getpid(), "function": rec.function, "faas": rec.faas,
                 "exec_id": rec.exec_id, "attempt": rec.attempt, "t_ms": time.time() * 1e3,
                 "cuda": cuda}
        if commit and rec.function == "decode":
            entry.update(launches=dict(ops.launches),
                         variants={"flash_attention": dict(ops.flash_variant_launches),
                                   "ssd_scan": dict(ops.ssd_variant_launches),
                                   "rglru_scan": dict(ops.rglru_variant_launches)},
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0)
            ops.reset_launches()
        entry["record_ms"] = (time.perf_counter() - t0) * 1e3
        _append_line(log, entry)
        return "kill" if fire else False
    return policy


def decode_lines(log: list) -> list:
    """The lines of :func:`remote_policy`'s log written after a decode's
    model run: one for each run."""
    return [e for e in log if e["function"] == "decode" and e["event"] != "claim"]


def _remote_params(cfg, log: str) -> dict:
    """A worker's serving weights (:func:`_serve_params`), built in the
    worker at its first decode, one worker at a time (a file lock beside
    ``log``): a build holds each leaf in fp32 before its cast, so three
    yi-9b builds at once do not fit the card beside the weights.  The
    blocks the build freed go back to the device.  Logs the seconds waited
    and spent, and the bytes."""
    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(log), "params.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t1 = time.perf_counter()
        params = _serve_params(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    _append_line(log, {"pid": os.getpid(), "wait_s": t1 - t0, "s": time.perf_counter() - t1,
                       "gb": torch.cuda.memory_allocated() / 1e9})
    return params


def _remote_pool(directory: str, kill: bool) -> RemoteRunner:
    os.makedirs(directory)
    runner = RemoteRunner(workers=REMOTE_WORKERS, lease_ms=REMOTE_LEASE_MS,
                          store_dir=os.path.join(directory, "store"))
    runner.crash_policy = remote_policy(os.path.join(directory, "policy.log"), kill)
    if torch.cuda.is_initialized():
        _fail("the remote coordinator initialised CUDA before forking its workers")
    return runner


def _close_pool(directory: str, runner: RemoteRunner) -> dict:
    """Close a pool of :func:`_remote_pool`; returns its workers and logs."""
    with open(os.path.join(runner.store_dir, "workers.json")) as f:
        workers = json.load(f)
    runner.close()
    return {"workers": workers, "log": _lines(os.path.join(directory, "policy.log")),
            "params_log": _lines(os.path.join(directory, "params.log"))}


def remote_workflow(directory: str) -> None:
    """Phase 5c's coordinator, a process of its own (:func:`phase_remote_workflow`
    starts it after this script has initialised CUDA): it drives three
    RemoteRunner pools, whose workers it forks, and never touches the card;
    each worker builds its own weights from the seed at its first decode.
    (a) yi-9b, one request, the aws/lambda decode replica's worker
    SIGKILLed at its output commit; (b) mamba2-370m, one request; (c)
    yi-9b, REMOTE_ARRIVALS open-loop Poisson arrivals through LoadRunner
    into one run().  Writes ``<directory>/result.json``, with each part's
    span on the wall clock (``t0_ms``, ``t1_ms``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in build.SOURCES if not build._target(n).exists()]
    if missing:
        _fail(f"remote coordinator: kernels {missing} not built by chip_smoke's phase 1")
    out = {}
    for part, arch, kill in (("a", "yi-9b", True), ("b", "mamba2-370m", False)):
        cfg, d = configs.get(arch), os.path.join(directory, part)
        runner = _remote_pool(d, kill)
        t0, t0_ms = time.perf_counter(), time.time() * 1e3
        r = workflow.run(functools.partial(_remote_params, cfg, os.path.join(d, "params.log")),
                         cfg, runner=runner, batch=REMOTE_BATCH, prompt_len=REMOTE_PROMPT,
                         steps=REMOTE_STEPS, seed=REMOTE_SEED, workflow_id=f"serve-{part}",
                         timeout_s=REMOTE_TIMEOUT / 2)
        out[part] = {**r, "part_s": time.perf_counter() - t0, "t0_ms": t0_ms,
                     "t1_ms": time.time() * 1e3, **_close_pool(d, runner)}
        _log(f"[remote] ({part}) {arch}: {r['completions']} detok completion(s), "
             f"{r['decode_calls']} decode executions, {out[part]['part_s']:.1f}s")
    d = os.path.join(directory, "c")
    runner = _remote_pool(d, kill=False)
    dep = deploy(runner, workflow.serve_spec(
        YI, functools.partial(_remote_params, YI, os.path.join(d, "params.log")),
        prompt_len=REMOTE_PROMPT, steps=REMOTE_STEPS))
    load = LoadRunner([dep])
    schedule = PoissonProcess(rate_wf_s=REMOTE_RATE_WF_S, seed=0).schedule(REMOTE_ARRIVALS)
    t0, t0_ms = time.perf_counter(), time.time() * 1e3
    for i, arrival in enumerate(schedule):    # request i's own prompt seed
        load.input_value = {"batch": REMOTE_BATCH, "seed": REMOTE_TRAFFIC_SEED + i}
        load.submit(ArrivalSchedule([arrival], meta=schedule.meta))
    load.drain(timeout_s=REMOTE_TIMEOUT / 2)
    part_s, t1_ms = time.perf_counter() - t0, time.time() * 1e3
    point = load.collect()
    requests = [{"workflow_id": wid, **workflow.outcome(dep_, wid)} for dep_, wid in load.started]
    out["c"] = {"point": {**point.as_dict(), "throughput_wf_s": point.throughput_wf_s,
                          "makespans_ms": point.makespans_ms},
                "arrivals_ms": [a.t_ms for a in schedule], "requests": requests,
                "part_s": part_s, "t0_ms": t0_ms, "t1_ms": t1_ms, **_close_pool(d, runner)}
    _log(f"[remote] (c) yi-9b: {point.completed} of {point.submitted} requests completed, "
         f"{part_s:.1f}s")
    if torch.cuda.is_initialized():
        _fail("the remote coordinator initialised CUDA")
    with open(os.path.join(directory, "result.json"), "w") as f:
        json.dump(out, f)


def _smi_memory_mib() -> int:
    """The card's memory in use, MiB, as nvidia-smi shows it."""
    return int(subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              text=True, check=True, timeout=60).stdout.split()[0])


def _remote_workers(part: str, r: dict, cfg, smi: list) -> tuple:
    """Hold every model run of a part's workers to one prefill's launches on
    the bf16 variants and every process that ran none to no CUDA context;
    print each worker, and the most memory nvidia-smi showed in the part's
    span of ``smi`` (this script's samples, (t_ms, MiB)).  Returns (the
    part's launches, by variant)."""
    want = _expected_launches(cfg)
    want_variants = {"flash_attention": {**dict.fromkeys(fa.VARIANTS, 0),
                                         "wgmma": want["flash_attention"]},
                     "ssd_scan": {**dict.fromkeys(ssd.VARIANTS, 0), "mma": want["ssd_scan"]},
                     "rglru_scan": {**dict.fromkeys(rg.VARIANTS, 0),
                                    "vec4": want["rglru_scan"]}}
    launches = dict.fromkeys(ops.launches, 0)
    variants = {k: dict.fromkeys(v, 0) for k, v in want_variants.items()}
    runs_all = decode_lines(r["log"])
    for d in runs_all:
        if d["launches"] != want or d["variants"] != want_variants:
            _fail(f"5c ({part}): a decode in pid {d['pid']} launched {d['launches']} "
                  f"({d['variants']}), not {want} on the bf16 variants")
        for k, n in d["launches"].items():
            launches[k] += n
        for k, by in d["variants"].items():
            for v, n in by.items():
                variants[k][v] += n
    decoders = {d["pid"] for d in runs_all}
    for name, pid in sorted(r["workers"].items()):
        mine = [e for e in r["log"] if e["pid"] == pid]
        if pid not in decoders and any(e["cuda"] for e in mine):
            _fail(f"5c ({part}): worker {name} ran no decode but initialised CUDA")
        runs = [d for d in runs_all if d["pid"] == pid]
        built = [p for p in r["params_log"] if p["pid"] == pid]
        claims = ", ".join(f"{k} x{n}" for k, n in collections.Counter(
            f"{e['function']}@{e['faas']}#{e['attempt']}" for e in mine
            if e["event"] == "claim").items())
        _log(f"[remote] ({part}) worker {name} (pid {pid}): claimed {claims or 'nothing'}; "
             + (f"{len(runs)} decode(s), weights built in {built[0]['s']:.2f}s after "
                f"{built[0]['wait_s']:.2f}s waiting for the build lock "
                f"({built[0]['gb']:.2f} GB), peak max_memory_allocated "
                f"{max(d['peak_gb'] for d in runs):.2f} GB" if runs
                else "never touched the card (no CUDA context)"))
    seen = [mib for t, mib in smi if r["t0_ms"] <= t <= r["t1_ms"]]
    _log(f"[remote] ({part}) nvidia-smi memory.used over the part: most "
         f"{max(seen) if seen else 'not sampled'} MiB in {len(seen)} samples (this script's "
         f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved and its context "
         f"included); the crash policy's line took at most "
         f"{max(e['record_ms'] for e in r['log']):.3f} ms")
    return launches, variants


def phase_remote_workflow() -> tuple:
    """Phase 5c: this script runs the direct greedy_generate calls on the
    card (bf16 serving weights from the seed, freed after), then starts
    :func:`remote_workflow` in a process of its own, samples the card's
    memory with nvidia-smi while it runs, and holds what it reports.
    Returns (each part's launches by path, by variant by path)."""
    seeds = {"yi-9b": [REMOTE_SEED] + [REMOTE_TRAFFIC_SEED + i for i in range(REMOTE_ARRIVALS)],
             "mamba2-370m": [REMOTE_SEED]}
    direct = {}
    for arch, arch_seeds in seeds.items():
        cfg = configs.get(arch)
        params = _serve_params(cfg)
        direct[arch] = {s: greedy_generate(params, cfg, torch.tensor(
            workflow.prompt_ids(cfg, REMOTE_BATCH, REMOTE_PROMPT, s), dtype=torch.long,
            device="cuda"), steps=REMOTE_STEPS).cpu().tolist() for s in arch_seeds}
        del params
        _free()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    directory = tempfile.mkdtemp(prefix="remote-", dir=os.path.join(ROOT, "build"))
    _log(f"[remote] this script: {torch.cuda.memory_allocated()} B allocated before the "
         f"coordinator starts")
    code = f"import chip_smoke; chip_smoke.remote_workflow({directory!r})"
    # a session of its own: on a timeout its whole process group (the
    # coordinator and the workers it forked) is killed
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, start_new_session=True,
                            env=dict(os.environ, PYTORCH_NVML_BASED_CUDA_CHECK="1"))
    smi, deadline = [], time.monotonic() + REMOTE_TIMEOUT
    while proc.poll() is None:
        if time.monotonic() > deadline:
            os.killpg(proc.pid, 9)
            proc.wait()
            _fail(f"the remote coordinator outlasted {REMOTE_TIMEOUT} s")
        smi.append((time.time() * 1e3, _smi_memory_mib()))
        time.sleep(REMOTE_SMI_S)
    if proc.returncode:
        _fail(f"the remote coordinator exited {proc.returncode}")
    with open(os.path.join(directory, "result.json")) as f:
        out = json.load(f)
    by_path, by_variant = _hold_remote(out, direct, smi)
    return by_path, by_variant, out


def _hold_remote(out: dict, direct: dict, smi: list) -> tuple:
    """Hold and print what :func:`remote_workflow` reported against the
    ``direct`` tokens of this script (arch -> seed -> ids).  Returns (each part's
    launches by path, by variant by path)."""
    by_path, by_variant = {}, {}
    a = out["a"]
    aws = {pid for name, pid in a["workers"].items() if name.startswith("aws-")}
    kills = [e for e in a["log"] if e["event"] == "kill"]
    if len(kills) != 1 or kills[0]["function"] != "decode" or \
            kills[0]["faas"] != workflow.PRIMARY or kills[0]["pid"] not in aws:
        _fail(f"5c (a): kills {kills}, not one of the aws/lambda decode replica's worker")
    killed = kills[0]["pid"]
    decodes = sorted((d["faas"], d["attempt"], d["status"]) for d in a["decodes"])
    if decodes != [(workflow.BACKUP, 0, "done"), (workflow.PRIMARY, 0, "running"),
                   (workflow.PRIMARY, 1, "done")]:
        _fail(f"5c (a): decode records {decodes}: not the killed attempt, its claim again "
              "and the backup")
    again = [e for e in a["log"] if e["event"] == "claim" and e["function"] == "decode"
             and e["faas"] == workflow.PRIMARY and e["attempt"] == 1]
    if len(again) != 1 or again[0]["pid"] not in aws - {killed}:
        _fail(f"5c (a): the killed attempt was claimed again by {again}, not the other "
              "aws worker")
    claimed = next(d for d in a["decodes"] if d["faas"] == workflow.PRIMARY
                   and d["attempt"] == 1)
    kill_to_claim = (claimed["t_start"] - kills[0]["t_ms"]) / 1e3
    for part, arch in (("a", "yi-9b"), ("b", "mamba2-370m")):
        r = out[part]
        if r["completions"] != 1:
            _fail(f"5c ({part}) {arch}: {r['completions']} detok completions, not 1")
        if part == "b" and (sorted((d["faas"], d["attempt"], d["status"]) for d in r["decodes"])
                            != [(workflow.BACKUP, 0, "done"), (workflow.PRIMARY, 0, "done")]
                            or any(e["event"] == "kill" for e in r["log"])):
            _fail(f"5c (b): decode records {r['decodes']}: not the two replicas, each once")
        if r["ids"] != direct[arch][REMOTE_SEED]:
            _fail(f"5c ({part}) {arch}: the committed tokens differ from the direct "
                  "greedy_generate call")
        runs = len(decode_lines(r["log"]))     # the killed attempt's run is in no record
        if runs != r["decode_runs"] + (part == "a"):
            _fail(f"5c ({part}): {runs} model runs recorded, {r['decode_runs']} in the "
                  "records")
        path = f"remote workflow ({part}): {arch}, {runs} decode runs"
        by_path[path], by_variant[path] = _remote_workers(part, r, configs.get(arch), smi)
        spans = ", ".join(
            f"{d['faas']}#{d['attempt']} {d['status']} "
            + (f"{(d['t_end'] - d['t_start']) / 1e3:.2f}s" if d["status"] == "done" else
               f"killed after {(kills[0]['t_ms'] - d['t_start']) / 1e3:.2f}s")
            for d in r["decodes"])
        _log(f"[remote] ({part}) {arch} full width ({configs.get(arch).n_layers}L), "
             f"{REMOTE_BATCH} x {REMOTE_PROMPT} prompt, {REMOTE_STEPS} steps: "
             f"{r['completions']} detok completion, {r['decode_calls']} decode executions "
             f"({spans}), {runs} ran the model; tokens equal the direct call; part "
             f"{r['part_s']:.1f}s (wall, the coordinator's clock)"
             + (f"; kill -9 of aws pid {killed} to its claim again by pid "
                f"{again[0]['pid']}: {kill_to_claim:.2f}s (lease {REMOTE_LEASE_MS:.0f} ms)"
                if part == "a" else ""))

    c = out["c"]
    p = c["point"]
    if p["submitted"] != REMOTE_ARRIVALS or p["completed"] != REMOTE_ARRIVALS or p["dropped"]:
        _fail(f"5c (c): load point {p}")
    for i, req in enumerate(c["requests"]):
        if req["completions"] != 1 or req["ids"] != direct["yi-9b"][REMOTE_TRAFFIC_SEED + i]:
            _fail(f"5c (c): request {req['workflow_id']}: {req['completions']} detok "
                  "completions, or tokens that differ from the direct call for its seed")
    attempts = [d for req in c["requests"] for d in req["decodes"]]
    if any(d["attempt"] or d["status"] != "done" for d in attempts):
        _fail(f"5c (c): a decode attempt was claimed again or did not finish: {attempts}")
    runs = len(decode_lines(c["log"]))
    if runs != sum(req["decode_runs"] for req in c["requests"]):
        _fail(f"5c (c): {runs} model runs recorded, not as many as the records show")
    path = f"remote workflow (c): yi-9b, {REMOTE_ARRIVALS} Poisson arrivals, {runs} decode runs"
    by_path[path], by_variant[path] = _remote_workers("c", c, YI, smi)
    _log(f"[remote] (c) yi-9b, {REMOTE_ARRIVALS} Poisson arrivals at {REMOTE_RATE_WF_S} wf/s "
         f"(seed 0; at {_ms_list(c['arrivals_ms'])} ms): LoadPoint submitted {p['submitted']}, "
         f"completed {p['completed']}, dropped {p['dropped']}, p50 {p['p50_ms']} ms, p99 "
         f"{p['p99_ms']} ms, mean {p['mean_ms']} ms, throughput {p['throughput_wf_s']:.3f} "
         f"wf/s over {p['duration_ms']} ms; {runs} decode runs for "
         f"{2 * REMOTE_ARRIVALS} replicas, each attempt within the lease (longest "
         f"{max(d['t_end'] - d['t_start'] for d in attempts) / 1e3:.2f}s); every request's "
         f"tokens equal the direct call for its seed; part {c['part_s']:.1f}s")
    return by_path, by_variant


# ==========================================================================
# 5b. dryrun: the dry run's predictions against the card
# ==========================================================================


#: the op of each kernel row in a dry run's kernel tallies
DRYRUN_OPS = {"flash_attention": "repro_torch.flash_attention_fwd",
              "ssd_scan": "repro_torch.ssd_scan_fwd", "rglru_scan": "repro_torch.rglru_scan_fwd",
              "ssd_scan_bwd": "repro_torch.ssd_scan_bwd",
              "rglru_scan_bwd": "repro_torch.rglru_scan_bwd",
              "flash_attention_bwd": "repro_torch.flash_attention_bwd"}
#: the measured peak a cell's predicted peak must lie within, relative
DRYRUN_RTOL = 0.05


def _serve_params(cfg):
    """bf16 serving weights from a seed, of the dry run's dtypes (its
    ``serve_dtype`` of the parameter tree)."""
    return dryrun.serve_dtype(lm.init(_gen(0), cfg.replace(param_dtype="bfloat16"),
                                      device="cuda"))


def _cublas_workspace() -> int:
    """Bytes of the cuBLAS workspace a thread's handle allocates at its
    first product on the card: the workspaces are released, one small
    product allocates this thread's again, and they are released after."""
    torch._C._cuda_clearCublasWorkspaces()
    _free()
    a = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    c = a @ a
    torch.cuda.synchronize()
    del c
    ws = torch.cuda.memory_allocated() - before
    del a
    torch._C._cuda_clearCublasWorkspaces()
    _free()
    return ws


def _dryrun_cell(name: str, cfg, spec, fn, args) -> dict:
    """Dry-run ``cfg`` at ``spec`` on fake CUDA tensors (nothing launched,
    nothing counted), then call ``fn(*args)`` on the card, which must be the
    same call: its launches equal the trace's operator calls; its peak
    (``max_memory_allocated`` after a reset, the arguments resident) lies
    within DRYRUN_RTOL of the predicted one.  The prediction holds the
    cuBLAS workspaces the call allocates (``workspace_bytes``: one for the
    caller's thread and, in a training step, one for autograd's device
    thread), so they are released before the call
    (``torch._C._cuda_clearCublasWorkspaces``).  Blocks that stay resident
    beside the arguments (``other``, printed) are taken off the measured
    peak: they belong to no call.  One more call is traced by
    torch.profiler (device kernels beside the ops dispatched), and five
    calls after two warm-up calls are timed one by one: their median gives
    the measured MFU (model_flops over it at the bf16 peak)."""
    rec = dryrun.run_cell(cfg, spec, verbose=False)
    if any(ops.launches.values()):
        _fail(f"dry run {name} counted launches {dict(ops.launches)}")
    predicted = rec["memory"]["peak_bytes"]
    workspaces = rec["memory"]["workspace_bytes"]
    arg_bytes = sum(op_cost.storages(args).values())
    torch._C._cuda_clearCublasWorkspaces()
    _free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    other = base - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    measured = torch.cuda.max_memory_allocated() - other
    launches = dict(ops.launches)
    del out
    calls = {k: rec["kernels"].get(op, {}).get("calls", 0) for k, op in DRYRUN_OPS.items()}
    if launches != calls:
        _fail(f"dry run {name}: operator calls {calls}, card launches {launches}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kernels = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    each = _each_ms(lambda: fn(*args))
    ms = statistics.median(each)
    mfu = rec["model_flops"] / (ms / 1e3 * ha.PEAK_FLOPS)
    r = {"predicted_peak_bytes": predicted, "cublas_workspace_bytes": workspaces,
         "other_resident_bytes": other, "measured_peak_bytes": measured,
         "rel_err": (predicted - measured) / measured, "argument_bytes": arg_bytes,
         "predicted_argument_bytes": rec["memory"]["argument_bytes"], "flops": rec["cost"]["flops"],
         "model_flops": rec["model_flops"], "flops_ratio": rec["cost"]["flops"] / rec["model_flops"],
         "bytes_accessed": rec["cost"]["bytes_accessed"], "ops": rec["ops"],
         "device_kernels": kernels, "first_ms": first_ms, "ms": ms, "ms_each": each,
         "mfu": mfu, "mfu_range": [rec["model_flops"] / (t / 1e3 * ha.PEAK_FLOPS)
                                   for t in (max(each), min(each))],
         "launches": launches, "trace_s": rec["trace_s"], "kernels": rec["kernels"],
         "ops_by_name": rec["ops_by_name"]}
    _log(f"[dryrun] {name}: peak predicted {predicted} B (cuBLAS workspaces {workspaces} B "
         f"of it), measured {measured} B (rel {r['rel_err']:+.5f}, limit {DRYRUN_RTOL}); "
         f"arguments {arg_bytes} B on the card (predicted {r['predicted_argument_bytes']}), "
         f"{other} B resident beside them (taken off); FLOPs {r['flops']:.6e} = "
         f"{r['flops_ratio']:.4f} x model_flops {r['model_flops']:.6e}; {r['ops']} ops "
         f"dispatched, {kernels} device kernels in the profiler's trace; median {ms:.3f} ms "
         f"of {_ms_list(each)} (first {first_ms:.3f}), MFU {mfu:.4f} (range "
         f"{r['mfu_range'][0]:.4f}-{r['mfu_range'][1]:.4f}); launches {launches}; trace "
         f"{r['trace_s']:.2f}s")
    if not abs(r["rel_err"]) <= DRYRUN_RTOL:
        _fail(f"dry run {name}: predicted peak {predicted} B against {measured} B measured")
    return r


def phase_dryrun() -> tuple:
    """The dry run (launch/dryrun.run_cell on fake CUDA tensors) of the
    cells this script runs, each held against the same call on the card:
    yi-9b at full width (48 layers), a prefill of [4, 512] and one decode
    step after it; mamba2-370m's and recurrentgemma-9b's prefills of
    [4, 512]; the training step of phase 6.  The two recurrent training
    steps of phase 6b are dry-run only, for the backward kernels' rows.
    Returns (each cell's measurements, the kernels' dry-run tallies, the
    launches of the measured calls)."""
    workspace = _cublas_workspace()
    _log(f"[dryrun] cuBLAS workspace of a thread's handle: {workspace} B (the dry run's "
         f"constant: {ha.CUBLAS_WORKSPACE_BYTES} B)")
    if workspace != ha.CUBLAS_WORKSPACE_BYTES:
        _fail(f"cuBLAS workspace {workspace} B, the dry run counts "
              f"{ha.CUBLAS_WORKSPACE_BYTES} B")
    ops.reset_launches()
    cells, tallies, by_path = {}, {}, {}
    prefill_spec = ShapeSpec("chip_prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")
    decode_spec = ShapeSpec("chip_decode", SERVE_PROMPT, SERVE_BATCH, "decode")

    def tally(rec_kernels):
        for row, op in DRYRUN_OPS.items():
            k = rec_kernels.get(op)
            if k and row not in tallies:
                tallies[row] = {"calls": k["calls"], "flops_per_call": k["flops"] / k["calls"],
                                "bytes_per_call": k["bytes"] / k["calls"]}

    with torch.inference_mode():
        for arch in ("yi-9b", "mamba2-370m", "recurrentgemma-9b"):
            cfg = configs.get(arch)
            params = _serve_params(cfg)
            tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=_gen(1),
                                   device="cuda", dtype=torch.int32)
            prefill = make_prefill_step(cfg, max_len=SERVE_PROMPT)
            ops.reset_launches()
            name = f"{arch} prefill [{SERVE_BATCH}, {SERVE_PROMPT}]"
            cells[name] = _dryrun_cell(name, cfg, prefill_spec, prefill,
                                       (params, {"tokens": tokens}))
            by_path[f"dryrun {name}"] = cells[name]["launches"]
            tally(cells[name]["kernels"])
            if arch == "yi-9b":
                cache, logits = prefill(params, {"tokens": tokens})
                token = logits.argmax(-1)[:, None].to(torch.int32)
                del logits
                ops.reset_launches()
                name = f"yi-9b decode step at {SERVE_PROMPT} slots"
                cells[name] = _dryrun_cell(name, cfg, decode_spec, make_decode_step(cfg),
                                           (params, token, cache))
                by_path[f"dryrun {name}"] = cells[name]["launches"]
                del cache, token
            del params, tokens
            _free()
    state = train_state_init(_gen(0), YI_TRAIN, device="cuda")
    batch = batch_to(_batch(YI_TRAIN, TRAIN_SEQ, TRAIN_BATCH), "cuda")
    ops.reset_launches()
    name = f"yi-9b train ({YI_TRAIN.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ})"
    cells[name] = _dryrun_cell(name, YI_TRAIN, ShapeSpec("chip_train", TRAIN_SEQ, TRAIN_BATCH,
                                                         "train"),
                               make_train_step(YI_TRAIN, lr=3e-4), (state, batch))
    by_path[f"dryrun {name}"] = cells[name]["launches"]
    tally(cells[name]["kernels"])
    del state, batch
    _free()
    ops.reset_launches()
    for cfg, b, l in ((MAMBA_TRAIN, MAMBA_TRAIN_BATCH, TRAIN_SEQ),
                      (RG_TRAIN, RG_TRAIN_BATCH, RG_TRAIN_SEQ)):
        rec = dryrun.run_cell(cfg, ShapeSpec("chip_train", l, b, "train"), verbose=False)
        tally(rec["kernels"])
    if set(tallies) != set(DRYRUN_OPS) or any(ops.launches.values()):
        _fail(f"dry runs tallied {sorted(tallies)} and counted {dict(ops.launches)}")
    _log("[dryrun] kernels per call in the dry runs: " + "; ".join(
        f"{k} {v['flops_per_call']:.6e} FLOP, {v['bytes_per_call']:.0f} B" for k, v in
        tallies.items()))
    return cells, tallies, by_path


# ==========================================================================
# 6. train, 7. grads, 8. commit, 9. refuse
# ==========================================================================


def _attn_moments_nonzero(state, cfg) -> bool:
    """Every attention weight of every layer had a nonzero gradient: its
    first moment after a step from zero is (1 − b1)·g, nonzero iff g is
    (weight decay moves the weight itself even without a gradient)."""
    m = state["opt"]["m"]["blocks"]
    return all(bool(m[f"s{i}"]["attn"][w][g].abs().max() > 0)
               for i in range(len(cfg.layer_pattern)) for w in ("wq", "wk", "wv", "wo")
               for g in range(lm.groups_of(cfg)[0]))


def phase_train() -> dict:
    """TRAIN_STEPS steps of make_train_step at yi-9b's width, then one step
    traced; returns the measurements and the flash launches of the steps."""
    cfg = YI_TRAIN
    per_step = 2 * cfg.n_layers            # remat "dots": each forward runs again
    t0 = time.perf_counter()
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    batches = [batch_to(_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step=s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    _log(f"[train] yi-9b width, {cfg.n_layers} layers: {cfg.param_count() / 1e9:.3f} B params, "
         f"state and batches ready in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for s in range(TRAIN_STEPS):
        n0, v0 = ops.launches["flash_attention"], dict(ops.flash_variant_launches)
        b0, bv0 = ops.launches["flash_attention_bwd"], dict(ops.flash_bwd_variant_launches)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        launched = ops.launches["flash_attention"] - n0
        wgmma = ops.flash_variant_launches["wgmma"] - v0["wgmma"]
        bwd = ops.launches["flash_attention_bwd"] - b0
        bwd_wgmma = ops.flash_bwd_variant_launches["wgmma"] - bv0["wgmma"]
        steps.append({"loss": loss, "grad_norm": gnorm, "step_ms": ms,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                      "flash_launches": launched, "flash_bwd_launches": bwd})
        _log(f"[train] step {s + 1}: loss {loss:.6f}, grad norm {gnorm:.6f}, {ms:.3f} ms, "
             f"{steps[-1]['tokens_per_s']:.1f} tokens/s, flash launches {launched} "
             f"({wgmma} wgmma), flash backward launches {bwd} ({bwd_wgmma} wgmma)")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            _fail(f"train step {s + 1}: loss {loss}, grad norm {gnorm}")
        if launched != per_step or wgmma != per_step:
            _fail(f"train step {s + 1}: {launched} flash launches ({wgmma} wgmma), "
                  f"not {per_step} wgmma under remat dots")
        if bwd != cfg.n_layers or bwd_wgmma != cfg.n_layers:
            _fail(f"train step {s + 1}: {bwd} flash backward launches ({bwd_wgmma} wgmma), "
                  f"not {cfg.n_layers} wgmma (one a layer)")
        if s == 0 and not _attn_moments_nonzero(state, cfg):
            _fail("an attention weight got a zero gradient")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"[train] peak memory {peak:.2f} GB over {TRAIN_STEPS} steps; launches {launches}")
    traced_ms, by_kernel = _device_profile(lambda: step_fn(state, batches[-1]), iters=1,
                                           warmup=0)
    classes = {}
    for name, ms in (by_kernel or {}).items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
    top = dict(sorted(classes.items(), key=lambda kv: -kv[1])[:5])
    kernels = dict(sorted((by_kernel or {}).items(), key=lambda kv: -kv[1])[:8])
    _log(f"[train] traced step: device busy {traced_ms:.3f} ms; largest classes (device ms) "
         + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + "; largest kernels "
         + ", ".join(f"{k[:60]} {v:.3f}" for k, v in kernels.items()))
    # the references of the sharded phase's last two steps: the bf16-gathered
    # step from this state, and a one-layer fp32 step from the seed
    _, m = make_train_step(cfg.replace(gather_dtype="bfloat16"), lr=3e-4)(
        state, batches[TRAIN_STEPS])
    gather_step = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del state, m
    _free()
    state = train_state_init(_gen(0), MESH_TRAIN_FP32, device="cuda")
    new, m = make_train_step(MESH_TRAIN_FP32, lr=3e-4)(state, batches[0])
    fp32_step = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    fp32_ref = {k: [t.cpu() for t in tree_leaves(tree)]
                for k, tree in (("params", new["params"]), ("m", new["opt"]["m"]))}
    _log(f"[train] plain references of the sharded phase: bf16-gathered step "
         f"{TRAIN_STEPS + 1} {gather_step}; fp32 {MESH_TRAIN_FP32.n_layers}-layer step 1 "
         f"{fp32_step}")
    del state, new, m
    _free()
    dense = _train_dense(cfg, batches[:TRAIN_STEPS], steps)
    del batches
    _free()
    return {"steps": steps, "peak_mem_gb": peak, "launches": launches,
            "traced_device_ms": traced_ms, "top_classes_ms": top, "top_kernels_ms": kernels,
            "dense_steps": dense, "gather_bf16_step": gather_step, "fp32_step": fp32_step,
            "fp32_ref": fp32_ref}


def _dense_causal(q, k, v, *, window, cap):
    return ref.flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)


def _train_dense(cfg, batches, steps) -> list:
    """The same steps from the same seed with attention differentiated by
    autograd through the dense plain version (no flash kernel, no FA2): the
    step-1 loss within 5e-2 and gradient norm within 5e-2 relative of the
    port's path (the dense path rounds p to bf16 before P·V in the backward
    too, FA2 keeps it fp32); the later steps are reported beside the port's."""
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    out = []
    with mock.patch.object(attention, "_flash_causal", _dense_causal):
        for batch in batches:
            state, m = step_fn(state, batch)
            out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    _log("[train] dense attention autograd, same seed and data: " + "; ".join(
        f"step {i + 1} loss {d['loss']:.6f} grad norm {d['grad_norm']:.6f} (flash path "
        f"{s['loss']:.6f}, {s['grad_norm']:.6f})" for i, (d, s) in enumerate(zip(out, steps))))
    if (abs(out[0]["loss"] - steps[0]["loss"]) > 5e-2
            or abs(out[0]["grad_norm"] - steps[0]["grad_norm"]) > 5e-2 * out[0]["grad_norm"]):
        _fail("the full-width step-1 loss or gradient norm differs from dense attention's")
    del state
    return out


# ==========================================================================
# 6c. sharded training: the train step under a mesh, 4 gloo ranks
# ==========================================================================


def _sharded_state(cfg, gen: torch.Generator, ctx) -> dict:
    """train_state_init(gen, cfg) placed by the rule table on ``gen``'s
    device: the global parameters are drawn, each rank keeps its blocks and
    drops the rest, and the moments are zero blocks (the global state never
    exists whole on a rank)."""
    params = lm.init(gen, cfg, device=gen.device)
    dparams = distribute_tree(params, param_shardings(params, ctx), ctx)
    del params
    _free()

    def zeros(d):
        return DTensor.from_local(torch.zeros(d.to_local().shape, dtype=torch.float32,
                                              device=gen.device),
                                  ctx.mesh, d.placements, run_check=False)

    return {"params": dparams, "opt": {"m": tree_map(zeros, dparams),
                                       "v": tree_map(zeros, dparams)},
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def _variant_launches() -> dict:
    """Each kernel's launches so far by variant (ops' counters)."""
    return {"flash_attention": dict(ops.flash_variant_launches),
            "ssd_scan": dict(ops.ssd_variant_launches),
            "ssd_scan_bwd": dict(ops.ssd_bwd_variant_launches),
            "rglru_scan": dict(ops.rglru_variant_launches),
            "rglru_scan_bwd": dict(ops.rglru_bwd_variant_launches),
            "flash_attention_bwd": dict(ops.flash_bwd_variant_launches)}


def _on_variants(launches: dict, variants: dict) -> dict:
    """``launches`` (kernel → count) as launches by variant, every one on
    the variant ``variants`` names for its kernel."""
    return {k: {**dict.fromkeys(v, 0), variants[k]: launches[k]}
            for k, v in _variant_launches().items()}


def _sharded_step(step_fn, state, batch) -> tuple:
    """One step under the ambient context: (new state, its record: loss,
    grad norm, host ms ended by a synchronise, each kernel's launches and
    launches by variant (flash's also as flash_launches, flash_by_variant),
    collectives)."""
    n0, v0 = dict(ops.launches), _variant_launches()
    c0, b0 = mesh_ctx.collective_stats["calls"], mesh_ctx.collective_stats["bytes"]
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    v1 = _variant_launches()
    variants = {k: {v: v1[k][v] - v0[k][v] for v in v0[k]} for k in v0}
    return state, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "step_ms": ms, "launches": {k: ops.launches[k] - n0[k] for k in n0},
                   "variants": variants,
                   "flash_launches": ops.launches["flash_attention"] - n0["flash_attention"],
                   "flash_by_variant": variants["flash_attention"],
                   "collectives": mesh_ctx.collective_stats["calls"] - c0,
                   "collective_bytes": mesh_ctx.collective_stats["bytes"] - b0}


def _timing(recs: list) -> dict:
    """The timing of the last of the steps ``recs``, run after
    ``reset_collective_stats(timed=True)``: its ms, collectives, their
    seconds on the host clock (each after a synchronise) and its loss; the
    counts are reset untimed.  (The callers loop over their steps
    themselves: a helper that took the state would keep the caller's first
    state alive through every step.)"""
    timing = {"step_ms": recs[-1]["step_ms"], "collectives": recs[-1]["collectives"],
              "collective_s": mesh_ctx.collective_stats["seconds"], "loss": recs[-1]["loss"],
              "step": len(recs)}
    mesh_ctx.reset_collective_stats()
    return timing


def _against_plain(tree, leaves, ctx, relative: bool) -> list:
    """Each rank's block of every leaf of ``tree`` (DTensors) against the
    same block of the plain step's leaf (``leaves``, global, on the host):
    max |d|, over the block's largest value when ``relative``."""
    errs = []
    for got, want in zip(tree_leaves(tree), leaves, strict=True):
        want = want[local_slices(tuple(got.shape), spec_of(got), ctx)].to(got.device)
        err = float((got.to_local() - want).abs().max())
        errs.append(err / (float(want.abs().max()) or 1.0) if relative else err)
    return errs


def _leaf_paths(tree, prefix: str = "") -> list:
    """The paths of ``tree``'s leaves, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def _mesh_train_rank(rank: int, world: int, directory: str) -> None:
    """One rank of the sharded training phase: phase 6's state and batches
    on this rank's blocks, TRAIN_STEPS steps (the last with every
    collective timed), the bf16-gathered step, then the one-layer fp32
    step.  Writes ``<directory>/rank<r>.json``."""
    mesh, r = _rank_mesh(rank, world, directory)
    ctx = launch_mesh.make_ctx(mesh)
    cfg = YI_TRAIN
    state = _sharded_state(cfg, _gen(0), ctx)
    batches = [batch_to(make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step=s), state["step"].device)
               for s in range(TRAIN_STEPS + 1)]
    r["state_gb"] = sum(t.to_local().numel() * t.to_local().element_size()
                        for t in tree_leaves(state) if mesh_ctx.is_distributed(t)) / 1e9
    r["local_wq"] = list(state["params"]["blocks"]["s0"]["attn"]["wq"].to_local().shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg, lr=3e-4)
    ops.reset_launches()
    r["steps"] = []
    with mesh_context(ctx):
        for s in range(TRAIN_STEPS):
            mesh_ctx.reset_collective_stats(timed=s == TRAIN_STEPS - 1)
            mem = _step_memory_start((state, batches[s]), _rank_blocks(state, batches[s])) \
                if s == 0 else None          # the step held against the dry run
            state, rec = _sharded_step(step_fn, state, batches[s])
            if mem is not None:
                rec["memory"] = _step_memory_end(mem)
            r["steps"].append(rec)
        r["timed"] = _timing(r["steps"])
        gather_fn = make_train_step(cfg.replace(gather_dtype="bfloat16"), lr=3e-4)
        after, r["gather_step"] = _sharded_step(gather_fn, state, batches[TRAIN_STEPS])
        r["gather_dtypes"] = sorted({str(t.dtype)[6:] for t in tree_leaves(after["params"])})
        del after, state
        _free()
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    state = _sharded_state(MESH_TRAIN_FP32, _gen(0), ctx)
    with mesh_context(ctx):
        state, r["fp32_step"] = _sharded_step(make_train_step(MESH_TRAIN_FP32, lr=3e-4), state,
                                              batches[0])
    plain = torch.load(MESH_TRAIN_FP32_REF, mmap=True)
    r["fp32_params_max_err"] = _against_plain(state["params"], plain["params"], ctx, False)
    r["fp32_m_rel_err"] = _against_plain(state["opt"]["m"], plain["m"], ctx, True)
    del state, plain
    _free()
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(r, f)
    dist.destroy_process_group()


def phase_mesh_train(plain: dict, fp32_ref: dict) -> tuple:
    """The sharded train step on MESH_RANKS ranks against phase 6's plain
    steps (``plain``: phase_train's record; ``fp32_ref``: the leaves of
    the plain fp32 step's updated parameters and first moments, on the
    host).  Fails unless every step's loss is within MESH_TRAIN_LOSS_TOL and
    its grad norm within MESH_TRAIN_GNORM_RTOL of the plain step's, the fp32
    step's loss and grad norm within MESH_TRAIN_FP32_RTOL, every rank's block
    of every updated parameter within MESH_TRAIN_PARAM_ATOL and of every
    first moment within MESH_TRAIN_FP32_RTOL of its largest, and each
    rank launched flash (wgmma, 2 a layer a step under remat dots; fma in
    fp32) and its backward (wgmma, one a layer; fma in fp32), and every rank's
    first step matches the dry run of one traced
    rank of the mesh (:func:`_hold_against_dryrun`).  Returns (the phase's
    flash launches, forward and backward, as a path's launches, each by
    variant, the ranks, each held step against the dry run)."""
    os.makedirs(os.path.dirname(MESH_TRAIN_FP32_REF), exist_ok=True)
    torch.save(fp32_ref, MESH_TRAIN_FP32_REF)
    dry = _start_mesh_dryrun("train")
    ranks, seconds = _spawn_ranks(_mesh_train_rank, MESH_TRAIN_TIMEOUT)
    os.remove(MESH_TRAIN_FP32_REF)
    traced = _mesh_dryrun_records(*dry)["train"]
    held = {f"rank {r['rank']} train": _hold_against_dryrun(
        f"rank {r['rank']} {r['coord']} yi-9b train step 1", traced,
        {"calls": r["steps"][0]["collectives"], "bytes": r["steps"][0]["collective_bytes"]},
        r["steps"][0]["launches"], r["steps"][0]["memory"]) for r in ranks}
    _log(f"[mesh-train] {MESH_RANKS} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH_SHAPE))}, yi-9b width, {YI_TRAIN.n_layers} layers, batch "
         f"{TRAIN_BATCH} x {TRAIN_SEQ}; a rank's wq block {ranks[0]['local_wq']}, its state "
         f"{ranks[0]['state_gb']:.3f} GB")
    per_step = 2 * YI_TRAIN.n_layers
    flash = {"flash_attention": dict.fromkeys(fa.VARIANTS, 0),
             "flash_attention_bwd": dict.fromkeys(fa.BWD_VARIANTS, 0)}
    wants = plain["steps"][:TRAIN_STEPS] + [plain["gather_bf16_step"]]
    for r in ranks:
        recs = r["steps"] + [r["gather_step"]]
        for i, (got, want) in enumerate(zip(recs, wants)):
            dl = abs(got["loss"] - want["loss"])
            dg = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
            gather = "bfloat16" if i == TRAIN_STEPS else '""'
            _log(f"[mesh-train] rank {r['rank']} {r['coord']} step {i + 1} (gather_dtype "
                 f"{gather}): loss {got['loss']:.6f} (plain {want['loss']:.6f}, |d| {dl:.3e}), "
                 f"grad norm {got['grad_norm']:.6f} (plain {want['grad_norm']:.6f}, rel "
                 f"{dg:.3e}), {got['step_ms']:.1f} ms, {got['collectives']} collectives, flash "
                 f"{got['flash_by_variant']}")
            if not (dl <= MESH_TRAIN_LOSS_TOL and dg <= MESH_TRAIN_GNORM_RTOL):
                _fail(f"rank {r['rank']} sharded step {i + 1}: {got} against plain {want}")
            if got["flash_by_variant"]["wgmma"] != per_step or got["flash_launches"] != per_step:
                _fail(f"rank {r['rank']} sharded step {i + 1}: flash {got['flash_by_variant']}, "
                      f"not {per_step} wgmma")
            if (got["launches"]["flash_attention_bwd"] != YI_TRAIN.n_layers
                    or got["variants"]["flash_attention_bwd"]["wgmma"] != YI_TRAIN.n_layers):
                _fail(f"rank {r['rank']} sharded step {i + 1}: flash backward "
                      f"{got['variants']['flash_attention_bwd']}, not {YI_TRAIN.n_layers} wgmma")
        if r["gather_dtypes"] != ["bfloat16"]:
            _fail(f"rank {r['rank']}: parameters after the bf16-gathered step are "
                  f"{r['gather_dtypes']}")
        t, f32, want = r["timed"], r["fp32_step"], plain["fp32_step"]
        _log(f"[mesh-train] rank {r['rank']} step {t['step']} timed: "
             f"{t['collectives']} collectives, {t['collective_s']:.3f} s of {t['step_ms']:.1f} ms "
             f"in them (host clock, each after a synchronise), loss {t['loss']:.6f}")
        df = abs(f32["loss"] - want["loss"]) / abs(want["loss"])
        dgf = abs(f32["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        _log(f"[mesh-train] rank {r['rank']} fp32 {MESH_TRAIN_FP32.n_layers}-layer step: loss "
             f"{f32['loss']:.7f} (plain {want['loss']:.7f}, rel {df:.3e}), grad norm "
             f"{f32['grad_norm']:.7f} (plain {want['grad_norm']:.7f}, rel {dgf:.3e}), flash "
             f"{f32['flash_by_variant']}")
        if not (df <= MESH_TRAIN_FP32_RTOL and dgf <= MESH_TRAIN_FP32_RTOL):
            _fail(f"rank {r['rank']} fp32 sharded step {f32} against plain {want}")
        errs, merrs = r["fp32_params_max_err"], r["fp32_m_rel_err"]
        _log(f"[mesh-train] rank {r['rank']} fp32 step: its blocks of the {len(errs)} updated "
             f"parameters against the plain step's, max |d| {max(errs):.3e} (leaf "
             f"{errs.index(max(errs))}); of the first moments, max |d| {max(merrs):.3e} of "
             f"the block's largest (leaf {merrs.index(max(merrs))})")
        if not (max(errs) <= MESH_TRAIN_PARAM_ATOL and max(merrs) <= MESH_TRAIN_FP32_RTOL):
            _fail(f"rank {r['rank']} fp32 sharded step: updated parameters differ from the "
                  f"plain step's by {errs}, first moments by {merrs} of their largest")
        if f32["flash_by_variant"]["fma"] != 2 * MESH_TRAIN_FP32.n_layers \
                or f32["variants"]["flash_attention_bwd"]["fma"] != MESH_TRAIN_FP32.n_layers:
            _fail(f"rank {r['rank']} fp32 sharded step: flash {f32['flash_by_variant']}, "
                  f"backward {f32['variants']['flash_attention_bwd']}")
        _log(f"[mesh-train] rank {r['rank']}: peak memory {r['peak_mem_gb']:.2f} GB over the "
             f"bf16 steps (phase 6's single process: {plain['peak_mem_gb']:.2f} GB)")
        for rec in r["steps"] + [r["gather_step"], r["fp32_step"]]:
            for k, by in flash.items():
                for v, n in rec["variants"][k].items():
                    by[v] += n
    launches = {**dict.fromkeys(ops.launches, 0),
                **{k: sum(by.values()) for k, by in flash.items()}}
    return launches, flash, ranks, held


# ==========================================================================
# 6d, 6f. sharded training of several archs (the recurrent families, the
# VLM and enc-dec families), 4 gloo ranks
# ==========================================================================


def _multimodal_leaf(path: str) -> bool:
    """The leaves phase 6f's fp32 check prints apart: the patch and frame
    projections, the cross-attention and its norm, the encoder."""
    return (path in ("w_patch", "w_frame") or path.startswith("encoder/")
            or "/lnx" in path or "/xattn/" in path)


#: the phases that train several archs on the ranks: the log's tag, the
#: bf16 configs and the fp32 ones by arch, the file of the batches and the
#: pattern of the fp32 leaves' files the parent writes for the ranks, the
#: bf16 steps (6d and 6f run one, for the script's time: the fp32 step
#: holds every rank's updated blocks, and 6c, 6e and 6g a second step),
#: whether the ranks also run a step with seq_shard_activations, the leaves
#: (a label, a predicate on their paths) whose fp32 errors are printed
#: apart, and optionally the ranks (MESH_RANKS by default) and the
#: MESH_DRYRUN cells their first step is held against
MESH_ARCH_PHASES = {
    "6d": {"tag": "mesh-rec", "cfgs": MESH_REC, "fp32": MESH_REC_FP32,
           "inputs": MESH_REC_INPUTS, "ref": MESH_REC_FP32_REF, "steps": 1, "seq_step": False,
           "focus": ("the per-head vectors",
                     lambda n: n.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias"))},
    "6f": {"tag": "mesh-mm", "cfgs": MESH_MM, "fp32": MESH_MM_FP32,
           "inputs": MESH_MM_INPUTS, "ref": MESH_MM_FP32_REF, "steps": 1, "seq_step": True,
           "focus": ("the multimodal leaves", _multimodal_leaf)},
    "6g": {"tag": "mesh-undivided", "cfgs": {"mamba2-370m": MESH_REC["mamba2-370m"]},
           "fp32": {"mamba2-370m": MESH_REC_FP32["mamba2-370m"]},
           "inputs": MESH3_TRAIN_INPUTS, "ref": MESH3_TRAIN_FP32_REF, "steps": TRAIN_STEPS,
           "seq_step": False,
           "focus": ("the per-head vectors",
                     lambda n: n.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")),
           "world": MESH3_RANKS, "dryrun": "train3"},
}


def _scan_calls_recorded(calls: dict):
    """The scans' forward calls recorded into ``calls`` (the SSD scan's x
    shape, the RG-LRU scan's log_a shape), each call passed on: context
    managers patching ``ops``."""
    def recorded(name, shape_of):
        kernel = getattr(ops, name)

        def call(*a, **kw):
            calls.setdefault(name, []).append(shape_of(*a))
            return kernel(*a, **kw)
        return mock.patch.object(ops, name, call)

    return (recorded("ssd_scan", lambda x, *_: list(x.shape)),
            recorded("rglru_scan", lambda a, *_: list(a.shape)))


def _rank_scan_calls(cfg, world: int) -> dict:
    """The scans' forward calls of one sharded step of ``cfg`` on a rank of
    the mesh of ``world`` ranks under remat "dots" (each scan layer's
    forward twice): the SSD scan on [B_loc, L, its heads, P], the RG-LRU
    scan on [B_loc, L, its width] (:func:`_rank_block`)."""
    data, m = MESH_SHAPES[world]
    b, kinds, out = TRAIN_BATCH // data, [cfg.pattern_of(i) for i in range(cfg.n_layers)], {}
    if cfg.ssm is not None:
        _, nh, p, _ = ssm.dims(cfg)
        out["ssd_scan"] = [[b, TRAIN_SEQ, _rank_block(nh, m), p]] * 2 * kinds.count("ssm")
    if cfg.rglru is not None:
        out["rglru_scan"] = [[b, TRAIN_SEQ, _rank_block(rglru.width(cfg), m)]] * 2 * \
            kinds.count("rglru")
    return out


def _plain_references(phase: str) -> dict:
    """The plain steps a phase of MESH_ARCH_PHASES is held against, on the
    card before the ranks start: per arch, the phase's bf16 steps from
    _gen(0) on make_batch's batches (each step's ms, positions/s and
    launches, exact on the bf16 variants; the peak memory), and the fp32
    step on the first batch.  Writes the batches and the fp32 steps'
    updated parameters and first moments for the ranks; returns each arch's
    record."""
    p = MESH_ARCH_PHASES[phase]
    os.makedirs(os.path.dirname(p["inputs"]), exist_ok=True)
    refs, inputs = {}, {}
    for arch, cfg in p["cfgs"].items():
        _free()
        t0 = time.perf_counter()
        batches = [batch_to(_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step=s), "cpu")
                   for s in range(p["steps"])]
        inputs[arch] = batches
        t_data = time.perf_counter() - t0
        state = train_state_init(_gen(0), cfg, device="cuda")
        step_fn = make_train_step(cfg, lr=3e-4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = _train_launches(cfg)
        steps = []
        for i, b in enumerate(batches):
            state, rec = _sharded_step(step_fn, state, batch_to(b, "cuda"))
            rec["positions_per_s"] = TRAIN_BATCH * TRAIN_SEQ / rec["step_ms"] * 1e3
            steps.append(rec)
            if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
                _fail(f"{arch} plain step {i + 1}: {rec}")
            if rec["launches"] != want or rec["variants"] != _on_variants(want, BF16_VARIANTS):
                _fail(f"{arch} plain step {i + 1}: launches {rec['variants']}, not {want} on "
                      f"{BF16_VARIANTS}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        _free()
        f32 = p["fp32"][arch]
        state = train_state_init(_gen(0), f32, device="cuda")
        new, m = make_train_step(f32, lr=3e-4)(state, batch_to(batches[0], "cuda"))
        fp32_step = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        del state, m
        _free()
        t1 = time.perf_counter()
        torch.save({k: [t.cpu() for t in tree_leaves(tree)]
                    for k, tree in (("params", new["params"]), ("m", new["opt"]["m"]))},
                   p["ref"].format(arch))
        del new
        _free()
        modal = {k: list(v.shape) for k, v in batches[0].items() if k in ("patches", "frames")}
        refs[arch] = {"steps": steps, "fp32_step": fp32_step, "peak_mem_gb": peak,
                      "params_b": cfg.param_count() / 1e9, "inputs": modal}
        _log(f"[{p['tag']}] plain references, {arch}: width {cfg.d_model}, {cfg.n_layers} "
             + (f"+ {cfg.n_enc_layers} " if cfg.enc_dec else "")
             + f"layers, {cfg.param_count() / 1e9:.3f} B params, tokens "
             f"{list(batches[0]['tokens'].shape)}" + (f", {modal}" if modal else "") + ": "
             + "; ".join(f"step {i + 1} loss {d['loss']:.6f} grad norm {d['grad_norm']:.6f}, "
                         f"{d['step_ms']:.1f} ms, {d['positions_per_s']:.1f} positions/s"
                         for i, d in enumerate(steps))
             + f"; peak memory {peak:.2f} GB; launches a step "
             f"{ {k: n for k, n in want.items() if n} } (bf16 variants); fp32 "
             f"{f32.n_layers}-layer step {fp32_step}; {time.perf_counter() - t0:.1f}s "
             f"({t_data:.1f}s of batches, {time.perf_counter() - t1:.1f}s writing the fp32 "
             f"leaves)")
    torch.save(inputs, p["inputs"])
    return refs


def _mesh_arch(phase: str, arch: str, mesh, batches: list) -> dict:
    """One arch of a phase of MESH_ARCH_PHASES on this rank: its state
    rebuilt from _gen(0) with this rank's blocks kept, the phase's sharded
    steps (the last with every collective timed on the host clock after a
    synchronise), where the phase asks for it one step from the initial
    state on the first batch with seq_shard_activations, then the fp32 step
    with its blocks against the plain step's."""
    p = MESH_ARCH_PHASES[phase]
    cfg, f32 = p["cfgs"][arch], p["fp32"][arch]
    ctx = launch_mesh.make_ctx(mesh)
    state = _sharded_state(cfg, _gen(0), ctx)
    local = sum(t.to_local().numel() * t.to_local().element_size()
                for t in tree_leaves(state) if mesh_ctx.is_distributed(t))
    r = {"state_gb": local / 1e9, "state_bytes": local,
         "state_share": _rule_share(state, ctx)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg, lr=3e-4)
    ops.reset_launches()
    r["steps"] = []
    with mesh_context(ctx):
        for i, b in enumerate(batches):
            mesh_ctx.reset_collective_stats(timed=i == len(batches) - 1)
            mem = _step_memory_start((state, b), _rank_blocks(state, b)) \
                if i == 0 and p.get("dryrun") else None   # held against the dry run
            calls = {}
            with contextlib.ExitStack() as stack:
                for patch in _scan_calls_recorded(calls):
                    stack.enter_context(patch)
                state, rec = _sharded_step(step_fn, state, b)
            rec["scan_calls"] = calls
            if mem is not None:
                rec["memory"] = _step_memory_end(mem)
            r["steps"].append(rec)
        r["timed"] = _timing(r["steps"])
    del state
    _free()
    if p["seq_step"]:
        state = _sharded_state(cfg, _gen(0), ctx)
        with mesh_context(launch_mesh.make_ctx(mesh, seq_shard_activations=True)):
            _, r["seq_step"] = _sharded_step(step_fn, state, batches[0])
        del state
        _free()
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    state = _sharded_state(f32, _gen(0), ctx)
    with mesh_context(ctx):
        state, r["fp32_step"] = _sharded_step(make_train_step(f32, lr=3e-4), state,
                                              batches[0])
    plain = torch.load(p["ref"].format(arch), mmap=True)
    r["fp32_leaves"] = _leaf_paths(state["params"])
    r["fp32_params_max_err"] = _against_plain(state["params"], plain["params"], ctx, False)
    r["fp32_m_rel_err"] = _against_plain(state["opt"]["m"], plain["m"], ctx, True)
    del state, plain
    _free()
    return r


def _mesh_archs_rank(phase: str, rank: int, world: int, directory: str) -> None:
    """One rank of a phase of MESH_ARCH_PHASES: each of its archs on this
    rank's blocks of the parent's batches.  Writes
    ``<directory>/rank<r>.json``."""
    mesh, r = _rank_mesh(rank, world, directory)
    p = MESH_ARCH_PHASES[phase]
    inputs = torch.load(p["inputs"])
    for arch in p["cfgs"]:
        r[arch] = _mesh_arch(phase, arch, mesh, [batch_to(b, "cuda") for b in inputs[arch]])
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(r, f)
    dist.destroy_process_group()


def _check_sharded(tag: str, who: str, a: dict, cfg, f32, plain: dict, focus: tuple) -> None:
    """One rank's record ``a`` of the sharded steps of ``cfg`` (and the fp32
    step of ``f32``) against the plain steps: fails unless every bf16
    step's loss is within MESH_TRAIN_LOSS_TOL and its grad norm within
    MESH_TRAIN_GNORM_RTOL (a ``seq_step`` under seq_shard_activations,
    where the record has one, against the plain step 1), every bf16 step
    (a capacity-factor step ``cf_step``, where the record has one,
    included)
    launches exactly _train_launches on the bf16 variants, the fp32 step's
    loss and grad norm are within MESH_TRAIN_FP32_RTOL with its launches on
    the fp32 variants, and the rank's block of every updated parameter is
    within MESH_TRAIN_PARAM_ATOL and of every first moment within
    MESH_TRAIN_FP32_RTOL of its largest.  ``focus`` is (a label, a
    predicate on leaf paths): those leaves' errors are printed apart."""
    want_launches = _train_launches(cfg)
    want_variants = _on_variants(want_launches, BF16_VARIANTS)
    recs = [(f"step {i + 1}", got, want)
            for i, (got, want) in enumerate(zip(a["steps"], plain["steps"], strict=True))]
    if "seq_step" in a:
        recs.append(("seq_shard_activations step (step 1's state and batch)", a["seq_step"],
                     plain["steps"][0]))
    if "cf_step" in a:
        recs.append((f"capacity factor {a['cf_step']['capacity_factor']} step (step 1's "
                     f"batch)", a["cf_step"], None))
    for what, got, want in recs:
        line = f"[{tag}] {who} {what}: loss {got['loss']:.6f}"
        if want is not None:
            dl = abs(got["loss"] - want["loss"])
            dg = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
            line += (f" (plain {want['loss']:.6f}, |d| {dl:.3e}), grad norm "
                     f"{got['grad_norm']:.6f} (plain {want['grad_norm']:.6f}, rel {dg:.3e})")
            if not (dl <= MESH_TRAIN_LOSS_TOL and dg <= MESH_TRAIN_GNORM_RTOL):
                _fail(f"{who} sharded {what}: {got} against plain {want}")
        else:
            line += (f", grad norm {got['grad_norm']:.6f}; this rank's experts took "
                     f"{got['routed']} assignments over {got['layers']} layers at capacity "
                     f"{got['capacity']} and dropped {got['dropped']} "
                     f"({got['dropped'] / got['routed']:.4%})")
            if not (math.isfinite(got["loss"]) and math.isfinite(got["grad_norm"])):
                _fail(f"{who} {what}: {got}")
        _log(line + f", {got['step_ms']:.1f} ms, {got['collectives']} collectives, launches "
             f"{ {k: n for k, n in got['launches'].items() if n} }")
        if got["launches"] != want_launches or got["variants"] != want_variants:
            _fail(f"{who} sharded {what}: launches {got['variants']}, not {want_variants}")
    got, want = a["fp32_step"], plain["fp32_step"]
    df = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    dg = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    errs, merrs, names = a["fp32_params_max_err"], a["fp32_m_rel_err"], a["fp32_leaves"]
    label, picked = focus
    some = [i for i, n in enumerate(names) if picked(n)]
    _log(f"[{tag}] {who} fp32 {f32.n_layers}-layer step: loss {got['loss']:.7f} (plain "
         f"{want['loss']:.7f}, rel {df:.3e}), grad norm {got['grad_norm']:.7f} (plain "
         f"{want['grad_norm']:.7f}, rel {dg:.3e}), launches "
         f"{ {k: n for k, n in got['launches'].items() if n} }; its blocks of the {len(errs)} "
         f"updated parameters against the plain step's, max |d| {max(errs):.3e} "
         f"({names[errs.index(max(errs))]}); of the first moments, max |d| {max(merrs):.3e} "
         f"of the block's largest ({names[merrs.index(max(merrs))]})" + (
             f"; {label} {[names[i] for i in some]}: max |d| "
             f"{max(errs[i] for i in some):.3e}, moments {max(merrs[i] for i in some):.3e}"
             if some else ""))
    if not (df <= MESH_TRAIN_FP32_RTOL and dg <= MESH_TRAIN_FP32_RTOL):
        _fail(f"{who} fp32 sharded step {got} against plain {want}")
    if not (max(errs) <= MESH_TRAIN_PARAM_ATOL and max(merrs) <= MESH_TRAIN_FP32_RTOL):
        _fail(f"{who} fp32 sharded step: updated parameters differ from the plain step's by "
              f"{dict(zip(names, errs))}, first moments by {dict(zip(names, merrs))}")
    want_launches = _train_launches(f32)
    if got["launches"] != want_launches or got["variants"] != _on_variants(want_launches,
                                                                           FP32_VARIANTS):
        _fail(f"{who} fp32 sharded step: launches {got['variants']}")


def _add_launches(total: dict, by_variant: dict, recs: list) -> None:
    """Add the records' launches into ``total`` (kernel → count) and
    ``by_variant`` (kernel → variant → count)."""
    for rec in recs:
        for k, n in rec["launches"].items():
            total[k] += n
        for k, by in rec["variants"].items():
            for v, n in by.items():
                by_variant[k][v] += n


def phase_mesh_train_archs(phase: str) -> tuple:
    """Phase 6d or 6f (MESH_ARCH_PHASES): the plain references
    (:func:`_plain_references`), the MESH_RANKS ranks
    (:func:`_mesh_archs_rank`), each rank's record checked
    (:func:`_check_sharded`); fails unless each arch's sharded steps
    launched every kernel its config launches.  Returns (the plain steps'
    records, their launches, by variant; the ranks' launches, by variant,
    per arch the launches at a rank's shape of the bf16 steps and the
    seq_shard_activations steps on all ranks; the ranks' records)."""
    p = MESH_ARCH_PHASES[phase]
    tag, cfgs, world = p["tag"], p["cfgs"], p.get("world", MESH_RANKS)
    t0 = time.perf_counter()
    dry = _start_mesh_dryrun(p["dryrun"]) if p.get("dryrun") else None
    plain = _plain_references(phase)
    ranks, seconds = _spawn_ranks(functools.partial(_mesh_archs_rank, phase),
                                  MESH_TRAIN_TIMEOUT, world)
    os.remove(p["inputs"])
    for arch in cfgs:
        os.remove(p["ref"].format(arch))
    held = {}
    if dry is not None:
        (arch,) = cfgs
        traced = _mesh_dryrun_records(*dry)["train"]
        for r in ranks:
            step = r[arch]["steps"][0]
            held[f"rank {r['rank']} train"] = _hold_against_dryrun(
                f"rank {r['rank']} {r['coord']} {arch} train step 1", traced,
                {"calls": step["collectives"], "bytes": step["collective_bytes"]},
                step["launches"], step["memory"])
    _log(f"[{tag}] {world} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH_SHAPES[world]))}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
         + ", ".join(f"{arch} {cfg.n_layers}" + (f" + {cfg.n_enc_layers}" if cfg.enc_dec else "")
                     + f" layers (a rank's state {ranks[0][arch]['state_gb']:.3f} GB)"
                     for arch, cfg in cfgs.items()))

    def zeros():
        return (dict.fromkeys(ops.launches, 0),
                {k: dict.fromkeys(v, 0) for k, v in _variant_launches().items()})

    plain_launches, plain_variants = zeros()
    _add_launches(plain_launches, plain_variants, [s for a in plain.values() for s in a["steps"]])
    launches, variants = zeros()
    at_rank_shape = {arch: dict.fromkeys(ops.launches, 0) for arch in cfgs}
    for r in ranks:
        for arch in cfgs:
            a = r[arch]
            _check_sharded(tag, f"rank {r['rank']} {r['coord']} {arch}", a, cfgs[arch],
                           p["fp32"][arch], plain[arch], p["focus"])
            want_calls = _rank_scan_calls(cfgs[arch], world)
            for i, s_ in enumerate(a["steps"]):
                if s_["scan_calls"] != want_calls:
                    _fail(f"rank {r['rank']} {arch} step {i + 1}: the scans ran at "
                          f"{s_['scan_calls']}, not the rank's shapes {want_calls}")
            bf16 = a["steps"] + [a[k] for k in ("seq_step",) if k in a]
            _add_launches(launches, variants, bf16 + [a["fp32_step"]])
            _add_launches(at_rank_shape[arch], zeros()[1], bf16)
            steps = a["steps"]
            _log(f"[{tag}] rank {r['rank']} {arch}: step ms "
                 f"{_ms_list([s['step_ms'] for s in steps])}"
                 + (f", seq_shard_activations step {a['seq_step']['step_ms']:.1f} ms "
                    f"({a['seq_step']['collectives']} collectives)" if "seq_step" in a else "")
                 + f", {steps[-1]['collectives']} collectives a step, "
                 f"{a['timed']['collective_s']:.3f} s of them in step {a['timed']['step']}'s "
                 f"{a['timed']['step_ms']:.1f} ms (timed); peak memory "
                 f"{a['peak_mem_gb']:.2f} GB (the "
                 f"plain single process: {plain[arch]['peak_mem_gb']:.2f} GB), state "
                 f"{a['state_gb']:.3f} GB ({a['state_bytes']} B; the rule table's share "
                 f"{a['state_share']} B)")
            if a["state_bytes"] != a["state_share"]:
                _fail(f"rank {r['rank']} {arch}: state {a['state_bytes']} B, not the rule "
                      f"table's share {a['state_share']} B")
    for arch, cfg in cfgs.items():
        missing = [k for k, n in _train_launches(cfg).items() if n and not at_rank_shape[arch][k]]
        if missing:
            _fail(f"phase {phase} launched no {missing} in {arch}'s sharded steps")
    _log(f"[{tag}] phase took {time.perf_counter() - t0:.1f}s; launches on all ranks "
         f"{launches}; the scans' forward calls a step at the rank's shapes "
         + "; ".join(f"{arch} " + ", ".join(f"{k} {len(v)} x {v[0]}" for k, v in
                                            _rank_scan_calls(cfg, world).items())
                     for arch, cfg in cfgs.items()))
    return plain, plain_launches, plain_variants, launches, variants, at_rank_shape, \
        {"ranks": ranks, "held": held}


# ==========================================================================
# 6e. sharded training of the MoE family, 4 gloo ranks
# ==========================================================================


def _mesh_moe_references() -> dict:
    """The plain steps phase 6e is held against, on the card before the
    ranks start: TRAIN_STEPS bf16 steps of MESH_MOE from _gen(0) on
    make_batch's batches (the first MoE training steps on the card: each
    step's ms, tokens/s, flash launches and the peak memory), and the fp32
    step of MESH_MOE_FP32 on the first batch.  Writes the batches
    (MESH_MOE_INPUTS) and the fp32 step's updated parameters and first
    moments (MESH_MOE_FP32_REF) for the ranks; returns the steps' record
    and their launches by kernel and by variant."""
    os.makedirs(os.path.dirname(MESH_MOE_INPUTS), exist_ok=True)
    _free()
    t0 = time.perf_counter()
    cfg = MESH_MOE
    batches = [batch_to(_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step=s), "cpu")
               for s in range(TRAIN_STEPS)]
    t_data = time.perf_counter() - t0
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    want = _train_launches(cfg)
    steps = []
    for i, b in enumerate(batches):
        n0, v0 = dict(ops.launches), _variant_launches()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch_to(b, "cuda"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launched = {k: ops.launches[k] - n0[k] for k in n0}
        wgmma = ops.flash_variant_launches["wgmma"] - v0["flash_attention"]["wgmma"]
        bwd_wgmma = (ops.flash_bwd_variant_launches["wgmma"]
                     - v0["flash_attention_bwd"]["wgmma"])
        steps.append({"loss": float(m["loss"]), "aux": float(m["aux"]),
                      "grad_norm": float(m["grad_norm"]), "step_ms": ms,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, "launches": launched})
        if not (math.isfinite(steps[-1]["loss"]) and math.isfinite(steps[-1]["grad_norm"])):
            _fail(f"deepseek-moe-16b plain step {i + 1}: {steps[-1]}")
        if launched != want or wgmma != want["flash_attention"] \
                or bwd_wgmma != want["flash_attention_bwd"]:
            _fail(f"deepseek-moe-16b plain step {i + 1}: launches {launched} ({wgmma} wgmma, "
                  f"{bwd_wgmma} wgmma backward), not {want} on wgmma")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, m
    _free()
    state = train_state_init(_gen(0), MESH_MOE_FP32, device="cuda")
    new, m = make_train_step(MESH_MOE_FP32, lr=3e-4)(state, batch_to(batches[0], "cuda"))
    fp32_step = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del state, m
    _free()
    t1 = time.perf_counter()
    torch.save({k: [t.cpu() for t in tree_leaves(tree)]
                for k, tree in (("params", new["params"]), ("m", new["opt"]["m"]))},
               MESH_MOE_FP32_REF)
    del new
    _free()
    torch.save(batches, MESH_MOE_INPUTS)
    _log(f"[mesh-moe] plain references: deepseek-moe-16b width, {cfg.n_layers} layers, "
         f"{cfg.param_count() / 1e9:.3f} B params, capacity factor "
         f"{cfg.moe.capacity_factor:.4f} (no_drop), batch {TRAIN_BATCH} x {TRAIN_SEQ}: " + "; ".join(
             f"step {i + 1} loss {d['loss']:.6f} (aux {d['aux']:.6f}) grad norm "
             f"{d['grad_norm']:.6f}, {d['step_ms']:.1f} ms, {d['tokens_per_s']:.1f} tokens/s"
             for i, d in enumerate(steps))
         + f"; peak memory {peak:.2f} GB; flash launches {launches['flash_attention']} (all "
         f"wgmma), backward {launches['flash_attention_bwd']} (all wgmma); fp32 {MESH_MOE_FP32.n_layers}-layer step {fp32_step}; "
         f"{time.perf_counter() - t0:.1f}s ({t_data:.1f}s of batches, "
         f"{time.perf_counter() - t1:.1f}s writing the fp32 leaves)")
    variants = {k: dict.fromkeys(v, 0) for k, v in _variant_launches().items()}
    variants["flash_attention"]["wgmma"] = launches["flash_attention"]
    variants["flash_attention_bwd"]["wgmma"] = launches["flash_attention_bwd"]
    return {"steps": steps, "fp32_step": fp32_step, "peak_mem_gb": peak,
            "params_b": cfg.param_count() / 1e9}, launches, variants


def _drop_recorder(record: list, n: int):
    """``moe.ep_partial`` that also keeps, for its first ``n`` calls (the
    forward's layers; the remat recompute calls it again), its router, token
    block and expert range, so that the assignments it drops are counted
    after the step (an op run inside the checkpointed forward would shift
    the saved products that the recompute replays)."""
    partial = moe.ep_partial

    def recorded(params, cfg, x_loc, lo):
        if len(record) < n:
            record.append((params["router"].detach(), x_loc.detach(), lo,
                           params["w_gate"].shape[0]))
        return partial(params, cfg, x_loc, lo)

    return recorded


def _rank_drops(record: list, cfg) -> dict:
    """Assignments to this rank's experts in the recorded calls, and those
    of them past an expert's capacity (``moe.ep_capacity`` on the block)."""
    routed = dropped = 0
    with torch.no_grad():
        for router, x_loc, lo, e_loc in record:
            ids, _ = moe.route({"router": router}, cfg, x_loc)
            s = moe.dispatch(ids, cfg.moe.num_experts, moe.ep_capacity(x_loc.shape[0], cfg))
            mine = (s["expert"] >= lo) & (s["expert"] < lo + e_loc)
            routed += int(mine.sum())
            dropped += int((mine & ~s["kept"]).sum())
    return {"routed": routed, "dropped": dropped, "capacity": moe.ep_capacity(
        record[0][1].shape[0], cfg), "layers": len(record)}


def _mesh_moe_rank(rank: int, world: int, directory: str) -> None:
    """One rank of phase 6e: MESH_MOE's state rebuilt from _gen(0) with this
    rank's blocks kept, TRAIN_STEPS sharded steps on the parent's batches
    (the last with every collective timed on the host clock after a
    synchronise), one step of MESH_MOE_CF (the
    config's capacity factor) with the assignments this rank drops, then
    the fp32 step of MESH_MOE_FP32 with its blocks against the plain
    step's.  Writes ``<directory>/rank<r>.json``."""
    mesh, r = _rank_mesh(rank, world, directory)
    ctx = launch_mesh.make_ctx(mesh)
    batches = [batch_to(b, "cuda") for b in torch.load(MESH_MOE_INPUTS)]
    cfg = MESH_MOE
    state = _sharded_state(cfg, _gen(0), ctx)
    r["state_gb"] = sum(t.to_local().numel() * t.to_local().element_size()
                        for t in tree_leaves(state) if mesh_ctx.is_distributed(t)) / 1e9
    r["local_w_gate"] = list(state["params"]["blocks"]["s0"]["moe"]["w_gate"].to_local().shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg, lr=3e-4)
    ops.reset_launches()
    r["steps"] = []
    record = []
    with mesh_context(ctx):
        for i, b in enumerate(batches):
            mesh_ctx.reset_collective_stats(timed=i == len(batches) - 1)
            state, rec = _sharded_step(step_fn, state, b)
            r["steps"].append(rec)
        r["timed"] = _timing(r["steps"])
        with mock.patch.object(moe, "ep_partial", _drop_recorder(record, cfg.n_layers)):
            state, r["cf_step"] = _sharded_step(make_train_step(MESH_MOE_CF, lr=3e-4), state,
                                                batches[0])
    r["cf_step"].update(_rank_drops(record, MESH_MOE_CF),
                        capacity_factor=MESH_MOE_CF.moe.capacity_factor)
    del record
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    _free()
    state = _sharded_state(MESH_MOE_FP32, _gen(0), ctx)
    with mesh_context(ctx):
        state, r["fp32_step"] = _sharded_step(make_train_step(MESH_MOE_FP32, lr=3e-4), state,
                                              batches[0])
    plain = torch.load(MESH_MOE_FP32_REF, mmap=True)
    r["fp32_leaves"] = _leaf_paths(state["params"])
    r["fp32_params_max_err"] = _against_plain(state["params"], plain["params"], ctx, False)
    r["fp32_m_rel_err"] = _against_plain(state["opt"]["m"], plain["m"], ctx, True)
    del state, plain
    _free()
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(r, f)
    dist.destroy_process_group()


def phase_mesh_train_moe() -> tuple:
    """Phase 6e: the plain references (:func:`_mesh_moe_references`), the
    MESH_RANKS ranks (:func:`_mesh_moe_rank`), each rank's record checked
    (:func:`_check_sharded`), and the capacity-factor step's loss the same
    on every rank.  Returns (the plain steps' record, their launches, by
    variant; the ranks' launches, by variant, the launches at a rank's
    shape of the bf16 steps and capacity-factor steps on all ranks; the
    ranks' records)."""
    t0 = time.perf_counter()
    plain, plain_launches, plain_variants = _mesh_moe_references()
    ranks, seconds = _spawn_ranks(_mesh_moe_rank, MESH_TRAIN_TIMEOUT)
    os.remove(MESH_MOE_INPUTS)
    os.remove(MESH_MOE_FP32_REF)
    _log(f"[mesh-moe] {MESH_RANKS} ranks in {seconds:.1f}s: mesh "
         f"{dict(zip(MESH_AXES, MESH_SHAPE))}, deepseek-moe-16b width, {MESH_MOE.n_layers} "
         f"layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}; a rank's w_gate block "
         f"{ranks[0]['local_w_gate']}, its state {ranks[0]['state_gb']:.3f} GB")
    launches = dict.fromkeys(ops.launches, 0)
    variants = {k: dict.fromkeys(v, 0) for k, v in _variant_launches().items()}
    at_rank_shape = dict.fromkeys(ops.launches, 0)
    for r in ranks:
        _check_sharded("mesh-moe", f"rank {r['rank']} {r['coord']}", r, MESH_MOE,
                       MESH_MOE_FP32, plain, ("the MoE leaves", lambda n: "/moe/" in n))
        for rec in r["steps"] + [r["cf_step"], r["fp32_step"]]:
            for k, n in rec["launches"].items():
                launches[k] += n
            for k, by in rec["variants"].items():
                for v, n in by.items():
                    variants[k][v] += n
        for rec in r["steps"] + [r["cf_step"]]:
            for k, n in rec["launches"].items():
                at_rank_shape[k] += n
        steps = r["steps"]
        _log(f"[mesh-moe] rank {r['rank']}: step ms {_ms_list([s['step_ms'] for s in steps])}, "
             f"{steps[-1]['collectives']} collectives a step, {r['timed']['collective_s']:.3f} s "
             f"of them in step {r['timed']['step']}'s {r['timed']['step_ms']:.1f} ms (timed); "
             f"peak memory "
             f"{r['peak_mem_gb']:.2f} GB (the plain single process: "
             f"{plain['peak_mem_gb']:.2f} GB), state {r['state_gb']:.3f} GB")
    cf = [r["cf_step"]["loss"] for r in ranks]
    if len(set(cf)) != 1:
        _fail(f"the capacity factor 1.25 step's loss differs between the ranks: {cf}")
    if not launches["flash_attention"]:
        _fail("phase 6e launched no flash")
    _log(f"[mesh-moe] phase took {time.perf_counter() - t0:.1f}s; launches on all ranks "
         f"{launches}")
    return plain, plain_launches, plain_variants, launches, variants, at_rank_shape, ranks


def phase_train_grads() -> dict:
    """The flash Function's gradients (the forward kernel, the backward
    kernel) against autograd through the dense plain version on the same
    card, yi-family heads (GQA 8/2, hd 128), L 256: fp32 (fma, fma) at
    1e-4, bf16 (wgmma, wgmma) at 3e-2, the reference's bf16 model tolerance,
    against fp32 autograd on the same bf16 inputs."""
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        want, want_bwd = fa.variant(128, dtype), fa.bwd_variant(128, dtype)
        base = list(_qkv(2, 256, 8, 2, 128, dtype, seed=11)) + [
            torch.randn((2, 256, 8, 128), generator=_gen(12), device="cuda").to(dtype)]
        q, k, v = (t.clone().requires_grad_() for t in base[:3])
        n0, b0 = dict(ops.flash_variant_launches), dict(ops.flash_bwd_variant_launches)
        flash.flash_attention(q, k, v, window=100, softcap=30.0).backward(base[3])
        if ops.flash_variant_launches != {**n0, want: n0[want] + 1}:
            _fail(f"the flash Function in {dtype} did not run the {want} variant")
        if ops.flash_bwd_variant_launches != {**b0, want_bwd: b0[want_bwd] + 1}:
            _fail(f"the flash Function's backward in {dtype} did not launch the "
                  f"{want_bwd} backward kernel once")
        q2, k2, v2 = (t.float().requires_grad_() for t in base[:3])
        ref.flash_attention_plain(q2, k2, v2, window=100, softcap=30.0).backward(
            base[3].float())
        errs[want] = max(_check(f"flash Function ({want}) d{n}", a.grad, b.grad, tol, tol)
                         for n, a, b in (("q", q, q2), ("k", k, k2), ("v", v, v2)))
    return errs


def _scan_moments_nonzero(state, cfg) -> list:
    """The scan-layer weights whose first moment is zero after a step from
    zero moments, i.e. that got a zero gradient (empty when all got one)."""
    m = state["opt"]["m"]["blocks"]
    return [f"s{i}.{key}.{w}" for i, kind in enumerate(cfg.layer_pattern)
            for key in ({"ssm": "ssm", "rglru": "rec"}.get(kind),) if key
            for w, t in m[f"s{i}"][key].items() if not bool(t.abs().amax() > 0)]


def _plain_ssd(x, dt, a, bmat, cmat, *, chunk=256, return_state=False):
    y, h_last = ref.ssd_chunked(x, dt, a, bmat, cmat, min(chunk, x.shape[1]))
    return (y, h_last) if return_state else y


def _plain_rglru(log_a, b, *, block_l=256, block_w=256):
    return ref.rglru_scan_ref(log_a, b)


def phase_train_recurrent(name: str, cfg, batch: int, seq: int, per_step: dict) -> dict:
    """TRAIN_STEPS steps of make_train_step on a recurrent arch at full
    width: each step's loss, grad norm, ms, tokens/s and launches (exactly
    ``per_step``: the scan forwards twice a layer under remat "dots", each
    backward kernel once, every forward on the serving variant), nonzero
    first moments for every scan-layer weight after step 1, peak memory;
    one more step traced (device time by class); then the same steps with
    both scans differentiated by autograd through their plain versions on
    the card, the step-1 loss and grad norm within STEP1_RTOL relative."""
    t0 = time.perf_counter()
    state = train_state_init(_gen(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr=3e-4)
    batches = [batch_to(_batch(cfg, seq, batch, step=s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    _log(f"[train] {name}: {cfg.n_layers} layers d{cfg.d_model}, "
         f"{cfg.param_count() / 1e9:.3f} B params, batch {batch} x {seq}; state and batches "
         f"ready in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for s in range(TRAIN_STEPS):
        n0 = dict(ops.launches)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        launched = {k: ops.launches[k] - n0[k] for k in n0}
        steps.append({"loss": loss, "grad_norm": gnorm, "step_ms": ms,
                      "tokens_per_s": batch * seq / ms * 1e3, "launches": launched})
        _log(f"[train] {name} step {s + 1}: loss {loss:.6f}, grad norm {gnorm:.6f}, "
             f"{ms:.3f} ms, {steps[-1]['tokens_per_s']:.1f} tokens/s, launches {launched}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            _fail(f"{name} train step {s + 1}: loss {loss}, grad norm {gnorm}")
        if launched != per_step:
            _fail(f"{name} train step {s + 1}: launches {launched}, not {per_step}")
        if s == 0:
            zero = _scan_moments_nonzero(state, cfg)
            if zero:
                _fail(f"{name}: scan-layer weights with a zero gradient: {zero}")
    launches = dict(ops.launches)
    want_variants = _on_variants(launches, BF16_VARIANTS)
    variants = _variant_launches()
    if variants != want_variants:
        _fail(f"{name} training launches by variant {variants}, not {want_variants}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"[train] {name}: peak memory {peak:.2f} GB over {TRAIN_STEPS} steps; launches "
         f"{launches}; by variant {variants}")
    traced_ms, by_kernel = _device_profile(lambda: step_fn(state, batches[-1]), iters=1,
                                           warmup=0)
    classes = {}
    for k, ms in (by_kernel or {}).items():
        classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + ms
    top = dict(sorted(classes.items(), key=lambda kv: -kv[1]))
    kernels = dict(sorted((by_kernel or {}).items(), key=lambda kv: -kv[1])[:8])
    _log(f"[train] {name} traced step: device busy {traced_ms:.3f} ms; classes (device ms) "
         + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + "; largest kernels "
         + ", ".join(f"{k[:60]} {v:.3f}" for k, v in kernels.items()))
    del state
    _free()

    state = train_state_init(_gen(0), cfg, device="cuda")
    plain = []
    with mock.patch.object(ops, "ssd_scan", _plain_ssd), \
            mock.patch.object(ops, "rglru_scan", _plain_rglru):
        ops.reset_launches()
        for b in batches[:TRAIN_STEPS]:
            state, m = step_fn(state, b)
            plain.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    scan_launches = {k: v for k, v in ops.launches.items() if "scan" in k and v}
    _log(f"[train] {name} with the scans differentiated through their plain versions: "
         + "; ".join(f"step {i + 1} loss {d['loss']:.6f} grad norm {d['grad_norm']:.6f} "
                     f"(kernels {k['loss']:.6f}, {k['grad_norm']:.6f})"
                     for i, (d, k) in enumerate(zip(plain, steps))))
    if scan_launches:
        _fail(f"{name}: the plain run launched scan kernels {scan_launches}")
    gaps = {k: abs(plain[0][k] - steps[0][k]) / abs(plain[0][k]) for k in ("loss", "grad_norm")}
    _log(f"[train] {name} step 1 against the plain scans, relative: loss {gaps['loss']:.2e}, "
         f"grad norm {gaps['grad_norm']:.2e} (limit {STEP1_RTOL})")
    if max(gaps.values()) > STEP1_RTOL:
        _fail(f"{name}: the step-1 loss or gradient norm differs from the plain scans' "
              f"by more than {STEP1_RTOL} relative")
    del state, batches
    _free()
    return {"steps": steps, "peak_mem_gb": peak, "launches": launches, "variants": variants,
            "traced_device_ms": traced_ms, "classes_ms": top, "top_kernels_ms": kernels,
            "plain_steps": plain, "params": cfg.param_count(), "batch": batch, "seq": seq,
            "layers": cfg.n_layers}


def phase_commit() -> dict:
    """The committed trainer at the "20m" preset of examples/train_pipeline.py
    (yi-family, d 384, 6 layers, hd 64: wgmma; seq 128, batch 4), 12 steps
    in chunks of 4, once uninterrupted and once with the primary controller
    killed after chunk 2."""
    cfg = configs.get_smoke("yi-9b").replace(
        d_model=384, n_layers=6, n_heads=6, n_kv_heads=3, head_dim=64, d_ff=1152,
        vocab=8192, remat="none")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fail_at in (("uninterrupted", None), ("failover", 2)):
            d = os.path.join(tmp, name)
            tr = CommittedTrainer(cfg, seq_len=128, global_batch=4, ckpt_dir=d,
                                  steps_per_chunk=4, lr=1e-3, device="cuda")
            ops.reset_launches()
            r = tr.train(12, fail_primary_at_chunk=fail_at)
            chunks = [m["step"] for m in tr.metrics]
            runs[name] = {"step": r.step, "loss": r.loss, "wall_s": r.wall_s,
                          "chunks": chunks, "commits": ckpt.all_steps(d),
                          "flash_launches": ops.launches["flash_attention"]}
            _log(f"[commit] {name}: step {r.step}, final chunk loss {r.loss:.6f}, "
                 f"{r.wall_s:.2f}s, chunks {chunks}, commits {runs[name]['commits']}, "
                 f"flash launches {runs[name]['flash_launches']}")
            if chunks != [4, 8, 12] or runs[name]["commits"] != [4, 8, 12]:
                _fail(f"committed trainer ({name}) did not commit each chunk exactly once")
    a, b = runs["uninterrupted"], runs["failover"]
    if a["step"] != b["step"] or abs(a["loss"] - b["loss"]) > 1e-4:
        _fail(f"failover run ended at step {b['step']}, loss {b['loss']}; uninterrupted "
              f"{a['step']}, {a['loss']}")
    _log(f"[commit] failover matches: |d loss| = {abs(a['loss'] - b['loss']):.3e} (tol 1e-4)")
    _free()
    return runs


def phase_refuse() -> None:
    """The flash wrapper outside the flash Function refuses inputs that need
    a gradient; a backward through the mamba2-370m and recurrentgemma-9b
    smoke configs on the card runs, finite, through each scan's backward
    kernel."""
    q = torch.zeros((1, 64, 4, 64), device="cuda", requires_grad=True)
    try:
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    except NotImplementedError:
        _log("[refuse] ops.flash_attention on inputs that need a gradient raises "
             "NotImplementedError (training goes through models/flash)")
    else:
        _fail("ops.flash_attention on the card took inputs that need a gradient")
    for arch, kernel in (("mamba2-370m", "ssd_scan_bwd"), ("recurrentgemma-9b", "rglru_scan_bwd")):
        cfg = configs.get_smoke(arch)
        params = lm.init(_gen(2), cfg, device="cuda")
        params["embed"].requires_grad_()
        batch = batch_to(make_batch(cfg, 64, 2), "cuda")
        ops.reset_launches()
        lm.loss_fn(params, cfg, batch)[0].backward()
        torch.cuda.synchronize()
        n = ops.launches[kernel]
        finite = bool(torch.isfinite(params["embed"].grad).all())
        _log(f"[refuse] {arch}: a backward on the card runs ({kernel} launched {n}x, "
             f"finite gradient {finite})")
        if n < 1 or not finite:
            _fail(f"{arch}: a backward on the card did not run through {kernel}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--skip-mesh"]):
        print(f"usage: chip_smoke.py [--skip-mesh]; got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _log(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    _LAP[0] = t_start
    _prefetch_batches()
    built = phase_build()
    _lap("1 build")
    rows = {"flash_attention": phase_flash(), "ssd_scan": phase_ssd(),
            "rglru_scan": phase_rglru()}
    _lap("2 kernels")
    bwd_rows = phase_scan_bwd()
    _lap("2 scan backwards")
    bwd_rows["flash_attention_bwd"], flash_bwd_at = phase_flash_bwd()
    _lap("2 flash backward")
    rank_rows = phase_rank_shapes()
    for phase, entry in flash_bwd_at.items():
        rank_rows.setdefault(phase, {})["flash_attention_bwd"] = entry
    _lap("2 rank shapes")
    at_rank_shape = {p: dict.fromkeys(ops.launches, 0) for p in rank_rows}
    phase_model()
    _lap("3 model")
    by_path, by_variant = {}, {}
    mesh_path = (f"mesh: {MESH_RANKS} ranks, yi-9b {MESH_YI.n_layers}L and deepseek-moe-16b "
                 f"{MESH_DS.n_layers}L prefills")
    mesh, mesh_serve, mesh_serve3, serve_at_rank, mesh_dry = None, None, None, {}, {}
    if argv != ["--skip-mesh"]:
        by_path[mesh_path], by_variant[mesh_path], mesh = phase_mesh()
        _lap("3b mesh")
        serve_path = f"mesh serve: {MESH_RANKS} ranks, " + ", ".join(
            f"{arch} {cfg.n_layers}L" for arch, (cfg, _) in MESH_SERVE.items())
        by_path[serve_path], by_variant[serve_path], serve_at_rank, mesh_serve, \
            mesh_dry["serve"] = phase_mesh_serve()
        _lap("3c mesh serve")
        serve3_path = f"mesh serve: {MESH3_RANKS} ranks {MESH3_SHAPE}, " + ", ".join(
            f"{arch} {MESH_SERVE[arch][0].n_layers}L" for arch, _ in MESH3_SERVE_CASES)
        by_path[serve3_path], by_variant[serve3_path], serve3_at_rank, mesh_serve3, \
            mesh_dry["serve3"] = phase_mesh_serve_undivided()
        serve_at_rank.update(serve3_at_rank)
        _lap("3d mesh serve undivided")
    by_path["yi-9b"], by_variant["yi-9b"] = phase_serve("yi-9b")
    phase_workflow("yi-9b")
    by_path["mamba2-370m"], by_variant["mamba2-370m"] = phase_serve("mamba2-370m")
    phase_workflow("mamba2-370m")
    by_path["recurrentgemma-9b"], by_variant["recurrentgemma-9b"] = phase_serve(
        "recurrentgemma-9b")
    by_path["deepseek-moe-16b"], by_variant["deepseek-moe-16b"] = phase_serve(
        "deepseek-moe-16b")
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-medium"):
        by_path[arch], by_variant[arch] = phase_serve(arch)
    prefix_path = "phi-3-vision-4.2b with the 576-patch prefix"
    _lap("4 serve, 5 workflow")
    by_path[prefix_path], by_variant[prefix_path], prefix = phase_vlm_prefix()
    _lap("4b prefix")
    remote_paths, remote_variants, remote = phase_remote_workflow()
    by_path.update(remote_paths)
    at_rank_shape["5c"] = {k: sum(n[k] for n in remote_paths.values()) for k in ops.launches}
    by_variant.update(remote_variants)
    _lap("5c remote workflow")
    for name in rows:
        rows[name]["launches_by_variant"] = {
            v: sum(n[name][v] for n in by_variant.values())
            for v in by_variant["yi-9b"][name]}
    t_dry = time.perf_counter()
    dry_cells, dry_kernels, dry_paths = phase_dryrun()
    _log(f"[dryrun] phase took {time.perf_counter() - t_dry:.1f}s")
    by_path.update(dry_paths)
    _lap("5b dryrun")
    train = phase_train()
    _lap("6 train")
    fp32_ref = train.pop("fp32_ref")
    by_path[f"yi-9b train ({YI_TRAIN.n_layers} layers, {TRAIN_STEPS} steps)"] = train["launches"]
    mesh_train = None
    mesh_train_flash = {"flash_attention": dict.fromkeys(fa.VARIANTS, 0),
                        "flash_attention_bwd": dict.fromkeys(fa.BWD_VARIANTS, 0)}
    if argv != ["--skip-mesh"]:
        by_path[f"mesh train: {MESH_RANKS} ranks, yi-9b {YI_TRAIN.n_layers}L"], \
            mesh_train_flash, mesh_train, mesh_dry["train"] = phase_mesh_train(train, fp32_ref)
        _lap("6c mesh train")
    # the flash backward's launches at phase 6c's rank shape, bf16 and fp32
    at_rank_shape["6c"]["flash_attention_bwd"] = \
        mesh_train_flash["flash_attention_bwd"]["wgmma"]
    at_rank_shape["6c fp32"]["flash_attention_bwd"] = \
        mesh_train_flash["flash_attention_bwd"]["fma"]
    del fp32_ref
    recurrent = {}
    for name, cfg, batch, seq in (("mamba2-370m", MAMBA_TRAIN, MAMBA_TRAIN_BATCH, TRAIN_SEQ),
                                  ("recurrentgemma-9b", RG_TRAIN, RG_TRAIN_BATCH, RG_TRAIN_SEQ)):
        r = phase_train_recurrent(name, cfg, batch, seq, _train_launches(cfg))
        _lap(f"6b {name} train")
        recurrent[name] = r
        by_path[f"{name} train ({cfg.n_layers} layers, {TRAIN_STEPS} steps)"] = r["launches"]
        at_rank_shape.setdefault(f"6b {name}", dict.fromkeys(ops.launches, 0))[
            "flash_attention_bwd"] = r["launches"]["flash_attention_bwd"]
        for k, row in rows.items():
            for v, n in r["variants"][k].items():
                row["launches_by_variant"][v] += n
    mesh_rec, mesh_moe, mesh_mm, mesh_undiv, extra_variants = None, None, None, None, []
    at_rank_shape.update(serve_at_rank)
    if argv != ["--skip-mesh"]:
        def train_paths(phase: str, what: str) -> tuple:
            """A phase of MESH_ARCH_PHASES: its plain and sharded steps as
            two paths, and their launches by variant."""
            plain, plain_path, plain_variants, path, variants, at_rank, out = \
                phase_mesh_train_archs(phase)
            p = MESH_ARCH_PHASES[phase]
            cfgs, world = p["cfgs"], p.get("world", MESH_RANKS)
            by_path[", ".join(f"{arch} train ({cfg.n_layers}"
                              + (f" + {cfg.n_enc_layers}" if cfg.enc_dec else "")
                              + f" layers, {p['steps']} steps)"
                              for arch, cfg in cfgs.items())
                    + (f" before phase {phase}" if world != MESH_RANKS else "")] = plain_path
            by_path[f"mesh train {what}: {world} ranks {MESH_SHAPES[world]}, " + ", ".join(
                f"{arch} {cfg.n_layers}L" for arch, cfg in cfgs.items())] = path
            return at_rank, {"plain": plain, **out}, [plain_variants, variants]

        rec_at_rank, mesh_rec, rec_variants = train_paths("6d", "recurrent")
        _lap("6d mesh train recurrent")
        at_rank_shape["6d"] = {k: sum(n[k] for n in rec_at_rank.values()) for k in ops.launches}
        plain_moe, plain_path, plain_variants, moe_path, moe_variants, at_rank_shape["6e"], \
            moe_ranks = phase_mesh_train_moe()
        by_path[f"deepseek-moe-16b train ({MESH_MOE.n_layers} layers, {TRAIN_STEPS} steps, "
                f"no_drop)"] = plain_path
        by_path[f"mesh train MoE: {MESH_RANKS} ranks, deepseek-moe-16b "
                f"{MESH_MOE.n_layers}L"] = moe_path
        mesh_moe = {"plain": plain_moe, "ranks": moe_ranks}
        _lap("6e mesh train MoE")
        mm_at_rank, mesh_mm, mm_variants = train_paths("6f", "multimodal")
        _lap("6f mesh train multimodal")
        for arch, n in mm_at_rank.items():
            at_rank_shape[f"6f {arch}"] = n
        undiv_at_rank, mesh_undiv, undiv_variants = train_paths("6g", "undivided")
        _lap("6g mesh train undivided")
        at_rank_shape["6g"] = undiv_at_rank["mamba2-370m"]
        mesh_dry["train3"] = mesh_undiv["held"]
        extra_variants = rec_variants + [plain_variants, moe_variants] + mm_variants + \
            undiv_variants
    rows.update(bwd_rows)
    for name, row in rows.items():      # the dry run's count beside the row's own
        row["dryrun"] = dry_kernels[name]
    for name, libs, key in (("rglru_scan_bwd", ("rglru_scan",), "rglru_scan_bwd"),
                            ("ssd_scan_bwd", ("ssd_scan_bwd_mma", "ssd_scan_bwd"), "ssd_bwd_"),
                            ("flash_attention_bwd", ("flash_attention_bwd",), "flash_bwd_")):
        rows[name]["ptxas"] = {fn: {"registers": regs, "spill_stores": st, "spill_loads": ld}
                               for lib in libs
                               for fn, regs, st, ld in _ptxas_report(built[lib]["log"])
                               if key in fn}
    for name, variants in (("rglru_scan_bwd", rg.VARIANTS), ("ssd_scan_bwd", ssd.VARIANTS),
                           ("flash_attention_bwd", fa.BWD_VARIANTS)):
        rows[name]["launches_by_variant"] = {
            v: sum(r["variants"][name][v] for r in recurrent.values()) for v in variants}
    for name, row in rows.items():
        for variants in extra_variants:
            for v, n in variants[name].items():
                row["launches_by_variant"][v] += n
    for phase, entries in rank_rows.items():
        for name, entry in entries.items():
            rows[name].setdefault("at_other_shapes", []).append(
                {**entry, "launches": at_rank_shape[phase][name]})
    for name, row in rows.items():
        row["launches_by_path"] = {arch: n[name] for arch, n in by_path.items()
                                   if n.get(name, 0)}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] <= 0:
            _fail(f"{name} was not launched on any main path")
    rows["flash_attention"]["launches_by_variant"]["wgmma"] += train["launches"][
        "flash_attention"]
    rows["flash_attention_bwd"]["launches_by_variant"]["wgmma"] += train["launches"][
        "flash_attention_bwd"]
    for name, by in mesh_train_flash.items():
        for v, n in by.items():
            rows[name]["launches_by_variant"][v] += n
    grads = phase_train_grads()
    commit = phase_commit()
    phase_refuse()
    _lap("7 grads, 8 commit, 9 refuse")
    _log(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels = {"kernels": list(rows.values())}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi, **kernels, "train": train, "train_recurrent": recurrent,
                   "train_grads_max_err": grads, "commit": commit, "vlm_prefix": prefix,
                   "mesh": mesh, "mesh_serve": mesh_serve, "mesh_serve_undivided": mesh_serve3,
                   "mesh_train": mesh_train,
                   "mesh_train_recurrent": mesh_rec, "mesh_train_moe": mesh_moe,
                   "mesh_train_multimodal": mesh_mm, "mesh_train_undivided": mesh_undiv,
                   "dryrun": dry_cells, "mesh_dryrun": mesh_dry, "remote_workflow": remote},
                  f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_batches()
