"""Drive dlrover_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --phases kernels,parity

Phases (each one's failure ends the run with a nonzero exit):
  device   torch sees a card; print nvidia-smi's name and power limit
  build    build the three CUDA libraries of ops/csrc (flash attention,
           norms, quantization), one nvcc each, all started together,
           and beside them the operator's native reconciler
           (native/*.cpp with g++ into build/native/); print each one's
           seconds and ptxas's register / spill report for every
           kernel; fail if a wgmma kernel (the flash forward, dQ or
           dK/dV) spills
  kernels  each flash-attention and RMSNorm kernel against its plain
           PyTorch version on the card at the Llama-1B slice shape, at
           edge shapes, at head dims 16, 32 and 96 (zero-padded by the
           wrappers to the kernels' 64 and 128) and at the GPT-2 small
           (b 12, h 12, s 1024, d 64, causal; and at tensor 2, the sp
           phase's (d): h 6) and BERT-base (b 32, h 12,
           s 512, d 64, bidirectional) and Llama-7B (b 2, h 32, s 2048, d
           128, causal; the norms at 4096 rows of 4096), Mixtral-width
           MoE (b 4, h 32 over 8 KV heads, s 2048, d 128, causal; the
           norms at 8192 rows of 4096; and at tensor 2, the sp phase's
           (d): h 16 over 4) and pipeline (Llama-1B's
           microbatch of 2: b 2, h 16, s 2048, d 128, causal; the norms
           at 4096 rows of 2048) shapes, and at the sp phase's ring block
           (b 1, h 16, s 2048, d 128, no mask), with
           stated tolerances, and o, dQ, dK and dV the same bits in a
           second call; time kernel, plain version and the library
           yardstick (SDPA, F.rms_norm) at the slice shape and at the
           seven model shapes
  quant    the quantization API (quantize, dequantize, swizzled,
           quant_reduce) on a Llama-1B gate_proj gradient, int8 and int4,
           bf16 input, group 8, zero and tie groups: every output equals
           the plain versions' bit for bit; time both kernels, their
           plain versions and torch.mul (dequantize's one-call yardstick)
  parity   a small Llama trained 3 steps with attn_impl="flash" and
           "reference", and with norm_impl="fused" and "reference", from
           the same init: losses, grad norms and gradients agree
  llama1b  Llama-1B at full width (22 layers, hidden 2048, seq 2048) in
           the JAX headline configuration (flash attention, fused norm)
           trained through ElasticTrainLoop, 2 warm-up + 5 timed steps;
           each flash kernel launches 22 times per step, rms_fwd and
           rms_bwd 45 times
  auto     auto_accelerate (dlrover_tpu_torch/auto/) on the card, in this
           process, from a Llama-1B factory written with the plain
           attention (fused norm, gather embedding, seq 2048, AdamW
           3e-4 wd 0.1). (a) ["amp", "module_replace"] at micro 8: the
           lowered config is the llama1b phase's (flash attention) and
           its steps through ElasticTrainLoop are that phase's losses
           bit for bit; it runs on to the observe phase's 46 steps when
           that phase runs, and is then its uninterrupted in-process
           reference; prints its steps beside that phase's median. (b)
           the default strategy (half + module_replace on one card) at
           micro 8 trains 3 steps on batches a coworker subprocess (it
           imports no torch) pushes through a ShmDataContext ring sized
           by PrefetchAutoTuner.ring_capacity, then 3 on batches it pushes
           with a CoworkerClient into a CoworkerDataService on 127.0.0.1;
           each batch's CRC, stamped by the coworker's native crc32, is
           recomputed on the card tensor by the checksum custom op and
           must match; the losses equal those of the same 6 steps fed
           the same batches directly; prints the coworker's start-up and
           the ring's capacity. (c) strategy="auto" at micro 2 with
           DLROVER_TPU_SEARCH_BUDGET=4 (the bo search's 4 dry runs of 1 +
           3 steps over the planner's 8 candidates): prints each
           candidate's steps/s or error; no candidate may fail on a
           kernel's build or launch, the fallback must not be reached,
           the pick trains 2 steps, and the allocator is back within 64
           MiB of its level before the search. (d) each part's launches
           as predicted from its lowered configs (22 a step a flash
           kernel, 45 a norm kernel; twice the forward ones under
           remat; none for a candidate with the plain attention)
  resume   Llama-1B at full width cut to 4 of its 22 layers
           (CKPT_LAYERS; also standalone's, faults', failover's,
           replan's and pipeline (d)'s) through
           ElasticTrainLoop with a flash checkpoint in a temporary
           directory (deleted at the end; the
           phase fails if the disk cannot hold one checkpoint, or the
           host's memory the pinned host copy plus one restore): A 7
           steps saving at 3, its host copy staged into a peer cache (on
           /dev/shm when that holds two stages), and a second, steady-state
           save after step 7 (dropped before B); the blocking part of both
           saves by piece (the first's page-locking timed apart); B a fresh loop restores 3 from disk and trains
           4-6, the same bits as A, the restore's peak device memory within
           the state plus its largest leaf; F a fresh loop with the peer
           cache and no master restores 3 through the local pseudo-plan:
           source "peer", the same bits as A, the same peak bound, its
           restore by part beside B's read; C the same as B with int8
           parameters, losses within 0.1% of A's, a quantize launch a
           parameter saving and a dequantize restoring (39 at 4 layers),
           codes bit for bit with the plain versions;
           D a worker process at 2 layers gets SIGTERM after its second
           step, saves where it stops and a second one resumes there (both
           processes are spawned when the phase starts and wait at a gate
           file once their loop is built, so their start-up runs beside
           A-C); E 3
           steps with AdamW's moments in pinned host memory, the same bits
           as A's first 3 (its step and peak beside A's)
  standalone
           the control plane: the port's JobMaster in this process, and
           `python -m dlrover_tpu_torch.run --master-addr ...` running
           the worker script dlrover_tpu_torch/examples/llama_train.py
           (Llama-1B at 4 layers, 7 steps saving at 3 and 6, a step report
           each step)
           under the port's agent, whose work directory (peer cache) is on
           /dev/shm when that holds two stages; once step 3 is committed
           and a peer stage at least as new is complete (the commit and
           the peer write run side by side; the kill waits for both)
           the worker is SIGKILLed and the agent relaunches it in the next
           rendezvous round. The relaunched worker restores with source
           "peer" through the master's plan at the newer of the committed
           step and the staged one (both read after the kill), and its
           steps, like the first incarnation's, are the same bits as
           resume's run A (or an uninterrupted in-process run when resume
           did not run); the agent exits 0, the master's SpeedMonitor
           holds step 7, its tokens/s read just after the kill (the first
           incarnation's step reports) is within 5% of the worker's own
           over the same steps, and the worker launched each flash kernel
           4 times and each RMSNorm kernel 9 times a resumed step. Prints
           host memory, the recovery time by part (the restore split into
           plan, transfer and assemble) up to the first resumed step and
           on to the second, the blocking saves by piece (each process's
           first save page-locks its host buffers, timed apart), and the
           step times beside the writers that ran under them
  faults   planned and silent failures under the port's JobMaster (in
           this process) and `python -m dlrover_tpu_torch.run`, the same
           Llama-1B worker at 4 layers (7 steps saving at 3 and 6, a step
           report each step). Launch 1: a chaos `preempt` notice at step 4 with
           a 90 s grace (and a `slow` hold of 3 s so the drain request
           lands at step 4's boundary): the agent exits 0, the worker
           76 classified drained, no charge, the emergency save
           `saved` and step 4 committed, notice to exit under the grace;
           prints notice → drain request → consumed step → exit, the
           emergency save's blocking part, commit and page-locking, and
           whether the 30 s default grace would have held. Launch 2,
           under DLROVER_TPU_HANG_WATCHDOG_S=7 with a chaos `hang` at
           step 7 (after the step-6 save): it resumes at the drained
           step, the watchdog aborts it once (its flight dump holds the
           main thread in the chaos sleep), the agent classifies the
           abort `hang` and relaunches it uncharged, the relaunch
           restores step 6 and finishes step 7 (replaying the hang
           within its first-step budget); every step is the same bits
           as resume's run A (or an in-process run); prints last step →
           abort → relaunch → first resumed step. Then the master's
           goodput ledger through `MasterClient.get_goodput`: its
           buckets cover the elapsed rank-seconds (within 5%), drain >
           0, 0 < hang ≤ the watchdog's 7 s. Each of the three worker
           processes launched every flash kernel 4 times and every
           RMSNorm kernel 9 times a step it finished

  observe  the master observes the card: the port's JobMaster in this
           process (diagnosis rounds and tsdb samples every 2 s, every
           other knob at its default) and `python -m dlrover_tpu_torch.run
           --monitor-interval 1` around the Llama-1B worker (46
           steps, no checkpoint, a step report each step) under the
           agent with its monitors, and a chaos `slow` fault of 1.5 s a
           step from step 37 on. Gates: every step report's
           hbm_peak_bytes equals the worker's own allocator peak
           (`allocated_bytes.all.peak`) at that step; a relayed
           NodeResourceStats carries the card's use and total; the
           step-time, tokens/s, MFU and HBM-peak series hold a point per
           sample interval of training; StepTraceRequest answers one
           group a step, gated by rank 0, its phases (data wait and
           the step report's host_sync included) within 5% of the
           period to the next step's start,
           the capture's two boundaries reported apart and the loop's
           young-generation collection at a boundary (logged by the
           worker) taken out of its period; the solo rank's
           CriticalPathRule issues profile:0, the agent requests it and
           the worker captures 5 steps with torch.profiler (manifest
           ok, the trace names the five training kernels; its size and
           export time printed); no hbm_pressure report; a critical
           throughput_collapse under the fault; the clean steps' median
           within 1% of the llama1b phase's and the first step after
           the capture inside their spread (the captured steps'
           slowdown printed); every loss and grad norm the bits of an
           uninterrupted in-process run
  failover the master survives its own death: a primary `python -m
           dlrover_tpu_torch.master.job_master --state-dir S
           --bootstrap-file B` with `kill:master:0@10`, a hot standby
           (the same with `--standby`, at its defaults: a probe every
           2 s, promotion after 3 failures) and `python -m
           dlrover_tpu_torch.run --monitor-interval 1` finding the
           master through B, around the same Llama-1B worker at
           CKPT_LAYERS (a report
           a step, saves every 8; the steps derived from the code's
           detection, promotion and reconnect bounds so that 5 follow
           the reconnect, printed); every master RPC of the agent and
           the worker has a 0.5 s deadline, cut from 30 s (a call to a
           dead master waits out its whole deadline). Gates: the primary
           dies by SIGKILL at step 10's report; one promotion, at the
           loaded snapshot's generation + 1, named by B; the agent's
           master-lost mode, one reconnect with world_intact=True, no
           new round, one worker pid from start to exit, its steps in
           order, exit 0; every step the bits of an uninterrupted run;
           the promoted master's first snapshot equal to the loaded one
           component by component (rendezvous, task manager, kv store,
           speed monitor, goodput ledger, diagnosis), and its tsdb
           holding the sidecar's points from before the kill. Prints
           kill → promotion (and the promotion) → master-lost mode →
           reconnect, the step period before the kill, in the outage and
           after the reconnect, the step reports that reached the
           promoted master, its goodput buckets and the phase's time
  replan   re-planning on resize: the port's JobMaster in this process
           (min 1, max 2 nodes, diagnosis every 2 s, a speed window of 8
           samples) and two `python -m dlrover_tpu_torch.run
           --monitor-interval 0.5` agents, ranks 0 and 1, each around the
           Llama-1B worker at CKPT_LAYERS as a `--solo-replica` (no
           process group, its
           own checkpoint directory) at batch 8 in micro batches of 2,
           both on the one card, 36 steps, a report a step, no interval
           save, `resize:-1@6`. Rank 1 leaves with the clean-drain exit at
           step 6, the master removes it, rank 0's agent stops its worker
           (the stop forces a save and a peer stage) and respawns it in
           one rendezvous round into world 1. Gates: the stamped plan goes
           from world 2 to world 1 at a higher epoch, feasible, the
           survivor applying "batch" (replica mode) then "mesh+batch";
           one round; the leaver drained; the restore from the
           survivor's own staged cut (source peer, no checkpoint read);
           replan_plan, replan_migrate (source peer) and replan_rebuild
           once each for the resize; the resumed steps bit for bit those
           of a solo world-1 worker in this process restored from the
           same staged cut (hard-linked aside); the master's speed
           re-anchored at the re-join (its window emptied, one card) and
           its tokens/s and MFU within 2% of the survivor's own over the
           same steps (its step lines' mean period); the calibration's world-1 entry with >= 3
           samples, predicted by the planner's formula on the ModelInfo
           (989e12); the ledger's replans row holding plan, migrate and
           rebuild; each worker's kernel launches exactly its steps'.
           Prints predicted against measured step time, whether
           PlanRegressionRule fired, the three legs' seconds, the leaver's
           drain to the first resumed step, both replicas' steps while
           they share the card and their allocator peaks
  models   the GPT-2 and BERT families at their published widths
           through ElasticTrainLoop (flash attention, bf16 activations,
           f32 master weights, AdamW(3e-4, wd 0.1), seed 0, 2 warm-up +
           5 timed steps): GPT-2 small (GPTConfig(): 12 x 768, 12 heads
           of 64, vocab 50304) at seq 1024, micro 12, global 480 (40
           micro-steps, nanoGPT's config/train_gpt2.py on one GPU) on the
           synthetic corpus; BERT-base (BertConfig.base(), non-causal) at
           seq 512, micro 32, global 256 (8 micro-steps) under mlm_loss
           with dense targets (each token scored against itself). Gates:
           finite losses and grad norms, the first loss near ln(vocab),
           the last timed loss below the first, each flash kernel
           launched 12 layers x micro-steps a step (480 and 96) and no
           other kernel. Prints the step's median and spread, tokens/s,
           MFU as the loop reports it and with the attention term in
           full, and the allocator peak. Then each family at 2 layers,
           full width, trained 3 steps with flash and with reference
           attention from one init: losses, grad norms and one step's
           gradients within the parity phase's limits. Then
           `python -m dlrover_tpu_torch.run --standalone --network-check`
           around dlrover_tpu_torch/examples/nanogpt_train.py --config
           gpt2 (built through auto_accelerate; seq 1024, global batch
           48, a save every 3 steps): the agent's probe runs on the card
           first (two rounds, both normal, before the worker is spawned;
           each round's window and the probe's time printed), 6 steps,
           exit 0; again to 9 steps without the check: it resumes at step
           6 and finishes 9; the 9 steps' losses and grad norms are those
           of the same steps built directly in this process, bit for bit
  llama7b  Llama-7B on one card (LlamaConfig.llama_7b: 32 x 4096, 32
           heads of 128, seq 2048, flash attention, fused norm, gather
           embedding, f32 weights) at micro 2 under the factored-RMS
           optimizer (optax.scale_by_factored_rms chained with
           scale(-3e-4), per leaf), the JAX headline's lean branch for a
           card over 60 GB. (a) at full width cut to 2 layers, one
           streaming and one dense step from one init on one batch:
           losses within 1e-3, grad norms 1e-2 relative, each
           parameter's update 2^-5 relative L2; (b) the streaming step
           (trainer/streaming.py) and (c) the dense step under
           remat="nothing_saveable", at full depth through
           ElasticTrainLoop, 2 warm-up + 5 timed steps: the loss falls,
           prints the step median and spread, tokens/s, the loop's MFU
           and the allocator peak; (d) the streaming trainer at 4 layers
           through ElasticTrainLoop(trainer=...) under a JobMaster in
           this process (a step report a step), its batches from
           prefetch_to_device at the prefetch tuner's depth: 6 steps
           against 3 saving at 3 and 3 more in a rebuilt loop from the
           restore, the same losses and parameters bit for bit; prints
           the depth gauge and the data-wait share; (e) Llama-1B as the
           llama1b phase runs it with remat under "nothing_saveable" and
           "dots_saveable": the peak below the llama1b run's, its step
           beside. Every run's launches as predicted with the recompute
           counted: flash_fwd 2 a layer and rms_fwd 4 a layer + 1 where
           the blocks run again (streaming, remat), else 1 and 2 + 1
  moe      the Mixtral-style family (models/llama_moe.py) at Mixtral-8x7B's
           published widths (MIXTRAL_WIDTHS: 4096 wide, experts of
           14336, 32 heads of 128 over 8 KV heads, 8 experts top-2, vocab
           32000) cut from 32 to 4 layers, flash attention, fused norm,
           gather embedding, f32 weights, bf16 activations, training
           routing (deterministic=False), Adafactor(3e-4) (the port's copy
           of optax.adafactor, the JAX example's), seq 2048, micro 4,
           global 8, seed 0. (a) 2 warm-up + 5 timed steps through
           ElasticTrainLoop: finite losses, the last timed loss below the
           first, each flash kernel 8 launches a step and each norm kernel
           18; prints the step median and spread, tokens/s, the loop's
           MFU (every expert counted, ROADMAP C12) and the MFU over the
           products done, the allocator peak, the aux loss, the share of
           top-2 assignments dropped at capacity (C13) and each expert's
           filled slots by layer; (b) 2 layers at full width from one
           init with flash and with reference attention: 3 training steps'
           losses and grad norms within the parity phase's limits, one
           step's gradients within its gradient limit with the reference
           run's routing pinned to the flash run's (a bf16 rounding before
           a router moves near-tied tokens to other experts; the share of
           assignments moved and the gradients with free routing are
           printed); (c) `python -m dlrover_tpu_torch.run
           --standalone` around dlrover_tpu_torch/examples/moe_train.py at
           its defaults: 6 steps saving every 3, then a resume to 9
  pipeline the circular pipeline (parallel/pipeline.py) and
           PipelinedTrainer (trainer/pipeline_trainer.py) at pipe 1.
           (a) Llama-1B at full width and depth (flash, fused norm,
           gather embedding, AdamW(3e-4, wd 0.1)) through
           build_pipeline_trainer at two rounds of 11 layers and 4
           microbatches of 2 rows (8 × 2048 tokens a step), through
           ElasticTrainLoop(trainer=...), 2 warm-up + 5 timed steps:
           finite losses, the first near ln(vocab), each flash kernel 88
           launches a step and each norm kernel 176 (the blocks' 2·L
           norms a microbatch: the exit's final norm is the plain one);
           prints the step's median and spread, tokens/s, the loop's MFU
           and the allocator peak beside the llama1b phase's; (b) the
           same weights through the dense trainer at accum 4, micro 2 on
           one batch: the step's loss and grad norm within the parity
           phase's limits, then 3 dense steps timed (the dense step at
           the pipeline's microbatching); (c) bound_activations (every schedule step
           checkpointed): 1 + 3 steps, flash_fwd and rms_fwd launched
           again in the recompute, its peak and step beside (a)'s; (d) at
           CKPT_LAYERS (two rounds of 2) through the loop with its
           checkpointer: 5 steps saving at 3, a new loop restoring 3
           trains 4-5 with the same losses and grad norms bit for bit
  embedding
           the job manager and elastic embedding training: the port's
           JobMaster in this process with job_args for 2 workers
           (restart_count 1) on a LocalCluster, and a CTR model at the
           MLPerf Training DLRM reference's scale on Criteo 1TB (26
           fields hashed into one table of 10M rows, cut from the
           reference's 40M cap, × 128 f32; batch 2048; the top MLP 3328 →
           1024 → 1024 → 512 → 256 → 1; BCE on 0/1 labels; data from
           seed 0, each field's ids a power law of exponent 1.2) through
           ElasticEmbeddingTrainer (row-sparse Adagrad 0.05 on the
           table, Adam 1e-3 on the tower), fed by ShardedDataset from
           the master's dynamic sharding, a FlashCheckpointer saving
           every 3 steps (on /dev/shm when it holds two checkpoints,
           else on disk). (a) 7 steps: after 3, the table's touched
           rows, their accumulator and the tower against the plain CPU
           run of the same 3 steps from the carried state (rows
           elementwise within rtol 1e-4 / atol 1e-7, the table's
           update within 1e-3 relative L2 and the accumulator's within
           5e-2, losses 1e-5 relative, the tower's update 1e-2 relative
           L2; the accumulator moved on some rows); no untouched row
           moved in
           the table or the accumulator, and some accumulator rows
           did; (b)
           LocalCluster.fail_pod on worker 1, which holds a shard: the
           global version goes to exactly 1, the shard is back in the
           queue, the job manager relaunches the pod (relaunch 1 of 1)
           and the trainer's needs_reconcile() turns true; a step on the
           stale view; (c) maybe_reconcile restores step 6: the table
           and accumulator the committed bits (the save's host copy),
           the step and data state rolled back, the local version
           published and read master-side, wait_reconciled_cluster over
           the live ids (the relaunch adopting the version) true, steps
           7-8 replayed the same bits and losses as they ran; (d) the
           master merges dataloader_batch_size 1024, the agent's
           ParalConfigTuner writes the file, the live ShardedDataset
           feed's next batch has 1024 rows and trains a step with a
           finite loss; (e) JobStatus reads the job manager's
           stage, GET /metrics on the exporter answers 200, the master
           stops (the node monitor ends, the exporter's socket closes).
           No kernel launches. Prints the step times, the allocator
           peak, the saves (blocking, commit, page-locking), the restore,
           the version timeline and the phase's seconds
  brain    the brain, the fleet controller and the operator: the port's
           BrainService on a local port (its sqlite store in a temporary
           directory) and a job-managed JobMaster on the local platform
           with optimize_mode "cluster", the brain's address and the fleet
           controller on (the JAX acceptance test's knobs: hysteresis 1,
           cooldown 0, claim margin 1.2, a 30 s goodput window; its own
           loop's cadence set past the phase, which evaluates itself).
           Rank 0 is Llama-1B at full width and depth (flash attention,
           fused norm, micro and global batch 2) through ElasticTrainLoop
           in this process, a step report a step; this process plays its
           agent (joins, re-joins, publishes the round's address). (b) A
           chaos `offer:slice:+1@30` through the master's injector; the
           phase evaluates the controller: a claim, priced under
           `autoscale` in the ledger, whose grant starts rank 1 (the same
           model as a `--solo-replica` worker under `python -m
           dlrover_tpu_torch.run`: a process, as the replan phase's
           replicas are. A thread would cost no start-up, but would share
           this process's launch counters and default stream and skip
           the agent's drain) and joins it in one rendezvous round;
           prints offer →
           decision (ms), decision → world of 2 (s). (c) A chaos
           `revoke:slice:1@8` on rank 1 (its slice) writes the preemption
           notice, its agent drains it (exit 76) and reports the drain;
           the master's copy, armed as rank 1 nears its step 8, books
           the revocation; the world goes back to 1 and rank 0 trains 5
           more steps, none lost; AutoscaleStatusRequest over the wire
           shows the claim "revoked" and no quarantine, the ledger's
           incarnations hold autoscale and drain, the flight record
           capacity_offer, autoscale_decision and capacity_revoke, the
           snapshot fleet_controller. Prints both replicas' steps, rank
           0's step alone and shared, both allocator peaks. (a) The
           brain's records of the live job by type (job_meta, model,
           runtime; job_exit once the master stops), the same over
           get_job_metrics; the runtime record's step (the card's) and
           allocator peak (the step reports' hbm_peak_bytes, within 1% of
           both processes' peaks); the master's BrainResourceOptimizer's
           oom-recovery plan from the brain: 1.8x the stored runtime
           peak. (d) The native reconciler built from native/*.cpp into
           build/native/ and in use (its calls counted): one ElasticJob
           on tests/fake_k8s.py (loaded by path): master pod, phase
           Running, a ScalePlan relayed to the phase's master; the pod
           scaler's worker pods request nvidia.com/gpu. Each flash kernel
           launches 22 times and each norm kernel 45 a step a replica
  sp       sequence parallelism (parallel/ring_attention.py) and the
           quantized gradient mean (parallel/quant_collectives.py) over two
           rank processes that share the card in one gloo group (NCCL
           puts no two ranks on one card; gloo moves a CUDA tensor through
           page-locked host memory, parallel/collectives.py). The ranks
           are spawned when the script starts: they import torch and the
           port, join the group and wait at a gate file, which opens after
           this process has trained the one-process reference and freed
           it. (a) Llama-1B's attention (b 1, 16 heads of 128, 4096 tokens
           as 2 × 2048), causal and not: each rank's output, dQ, dK and dV
           of the ring over the flash kernels and of Ulysses (the kernels
           on 8 heads over the whole sequence) within the flash tolerance
           (the kernels phase's rule) of the same shards of the
           one-process kernels on the whole sequence, and within its
           relative L2 limit of the plain (einsum) ring on the same
           inputs, which rounds at other points (f32 P and dS);
           the causal ring's rank r launches r + 1 forward, dQ and dK/dV
           kernels, the full ring 2 of each, Ulysses 1. (b) Llama-1B at
           full width cut to 2 of its 22 layers (SP_LAYERS; hidden 2048;
           flash blocks, fused norm, gather embedding, AdamW(3e-4, wd
           0.1)) at seq 4096
           and micro 1 over sequence 2, 3 steps with the ring and 3 with
           Ulysses through build_trainer from the seed-0 init, against
           the same rows trained at seq 4096 by this process alone with
           attn_impl="flash": each step's loss within the parity phase's
           2e-2 and its grad norm within 1e-2 relative; prints each step's
           time, each rank's allocator peak and the host staging's seconds
           a step; each rank's launches as predicted (the ring's rank r
           2·(r + 1) of each flash kernel a step, Ulysses 2, the norms
           5). (c) quantized_pmean over one Llama-1B block's gradient
           leaves (q, k, v, o, gate, up, down, both norms: 50.6M values,
           each rank's from its own seed) in gather and scatter mode at 8
           and 4 bits: the kernels' result equals the plain versions' (the
           same collective on CPU copies) bit for bit and is within the
           reference's bound of the exact mean; a quantize and a dequantize
           launch a leaf in gather mode, two of each in scatter. (d)
           tensor and expert parallelism over the two ranks: GPT-2 small
           (768 wide, vocab 50304, seq 1024, micro 12, causal) and
           BERT-base (768 wide, seq 512, micro 32, bidirectional, dense
           MLM targets) at full width cut to SP_TENSOR_LAYERS of their 12
           layers over tensor 2 (the head-major fused qkv giving each
           rank 6 of the 12 heads), AdamW(3e-4, wd 0.1); the
           Mixtral-width MoE at MOE_PARITY_LAYERS over tensor 2 (16 of 32
           query heads, 4 of 8 KV heads and 7168 of 14336 columns of
           every expert a rank), Adafactor(3e-4), micro 4, seq 2048, on
           the rows the moe phase's flash parity run trains on (that run
           is its reference when the moe phase ran); the pipelined
           Llama-1B at CKPT_LAYERS over pipe 1 × tensor 2 (8 of 16 heads
           a rank) and the pipelined Mixtral-width MoE at
           MOE_PARITY_LAYERS over pipe 1 × expert 2 (4 of 8 experts a
           rank), 2 microbatches of 2 rows; 3 steps each from the seed-0
           init against the same rows trained at tensor and expert 1 by
           this process: each step's loss and grad norm within (b)'s
           limits; each rank's launches as predicted, every flash launch
           at the case's shape with the rank's heads; DTensor running no
           collective of its own but the grad norm's scalar all-reduces
           (counted by a dispatch mode, ``collective_counter``); a
           GPT or BERT block's q, k and v of a replicated activation
           sharded over heads with no collective counted; the MoE over
           tensor's expert kernels (E, H, M/2) and (E, M/2, H), and one
           step's gradients (k_proj, router, wi at every 16th embed row)
           with each layer's routing pinned to the one-process run's
           within the parity phase's limit; the share of the routing's
           kept assignments that moved printed for both MoE cases;
           prints each step's time, each rank's allocator peak and the
           host staging's seconds a step. (e) two slices in one
           program: Llama-1B at full width cut to SP_LAYERS over dcn 2
           (one rank a slice), seq 2048, micro 2 a rank, AdamW(3e-4, wd
           0.1), grad_reduce_bits 8: the in-slice mean exact and the mean
           over dcn through quantized_pmean (the quantize and dequantize
           kernels), 3 steps from the seed-0 init against the same 4 rows
           trained exactly by this process: each step's loss and grad norm
           within (b)'s limits; each rank's launches as predicted (the
           flash and norm kernels of its 2 rows a step, one quantize and
           one dequantize a gradient leaf a step: gather mode at two
           members); prints each step's time, the host staging and each
           rank's allocator peak. The phase prints each part's seconds
           (the slower rank's) and probes which gloo collectives take
           CUDA tensors
  slice    slice mode's host-level path under the port's own control
           plane, beside the sp phase (it starts before it and is checked
           after): a JobMaster in this process and two agents, ``python
           -m dlrover_tpu_torch.run --slice-id 0`` and ``--slice-id 1``,
           one rank each, training the nanoGPT example at --config nano
           on the card for SLICE_STEPS steps (a save every
           SLICE_SAVE_EVERY, a step report every step), the cross-slice
           gradient mean exact through the master's KV store
           (parallel/dcn_sync.py) with a SLICE_DCN_TIMEOUT_S collect
           window; kill:slice:0@SLICE_KILL_AT kills the whole of slice
           0. Checks: the survivor's worker never restarts and slice 1's
           generation stays 1; a degraded step is counted by the master's
           ledger and by dlrover_tpu_slice_degraded_steps_total{slice="1"};
           slice 0 re-forms alone with its generation bumped, restores
           from its agent's peer cache and catches up to the fleet step
           through the state handoff; both slices end at the last step
           with the same parameters bit for bit (their SHA-256) after at
           least SLICE_LOCKSTEP steps in lockstep. Prints the exact
           payload's bytes beside C10's 64 MB gRPC value limit and the
           phase's seconds against its SLICE_BUDGET_S

Each phase's seconds are printed before the elapsed time, and after it
the elapsed time against the script's 950 s budget, part (d)'s
against its 30 s, part (e)'s against its 15 s and the slice phase's
against its 45 s (printed, not gates: the contract's limit is 1200 s).
The line
before the last is the kernels' JSON record (the quantization
pair's launches are the resume phase's checkpoint path; each kernel's
"standalone_launches" are those the worker under the agent printed for
its resumed incarnation, its "faults_launches" the sum over the faults
phase's three worker processes, its "observe_launches" the observe
phase worker's, its "failover_launches" the failover phase worker's,
its "replan_launches" the replan phase's three incarnations', its
"models_launches" the models phase's GPT-2 and BERT runs', its
"llama7b_launches" the llama7b phase's streaming and dense remat runs at
full depth, its "moe_launches" the moe phase's Mixtral-width run and
its "pipeline_launches" the pipeline phase's run (a), its
"auto_launches" the auto phase's (a)-(c), its
"embedding_launches" the embedding phase's steps, reconcile and replay
(none of the kernels is on that path: 0), its "brain_launches" the
brain phase's two replicas' steps, its "sp_launches" the sp phase's
two ranks' (b), (d) and (e) runs and (c) means;
each flash kernel's "at_gpt2", "at_gpt2_tp2" (GPT-2 small at tensor 2:
b 12, h 6, s 1024, d 64, causal), "at_bert", "at_llama7b",
"at_mixtral", "at_mixtral_tp2" (the Mixtral width at tensor 2: b 4, h 16
over 4 KV heads, s 2048, d 128, causal), "at_pipeline" and
"at_ring_block" (the sp phase's ring
block without the mask: b 1, h 16, s 2048, d 128), and each norm
kernel's "at_llama7b"
(4096 rows of 4096), "at_mixtral" (8192 rows of 4096) and
"at_pipeline" (4096 rows of 2048), hold its times, bound and error
at those shapes); the last line is {"ok": true,
"device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import signal
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
# ≈40 ms of device sleep at the H100's 1.98 GHz boost clock: longer than
# the host takes to queue the timed calls
SLEEP_CYCLES = 80_000_000
LIBRARIES = ["flash_attention", "norms", "quantization"]
CSRC = "dlrover_tpu_torch/ops/csrc/"
# each kernel's source in this repo and the Pallas kernel body it replaces
KERNELS = {
    "flash_fwd": ("flash_attention.cu",
                  "dlrover_tpu/ops/flash_attention.py:129"),
    "flash_bwd_dq": ("flash_attention.cu",
                     "dlrover_tpu/ops/flash_attention.py:249"),
    "flash_bwd_dkv": ("flash_attention.cu",
                      "dlrover_tpu/ops/flash_attention.py:293"),
    "rms_fwd": ("norms.cu", "dlrover_tpu/ops/norms.py:25"),
    "rms_bwd": ("norms.cu", "dlrover_tpu/ops/norms.py:34"),
    "quantize": ("quantization.cu", "dlrover_tpu/ops/quantization.py:48"),
    "dequantize": ("quantization.cu", "dlrover_tpu/ops/quantization.py:58"),
}
# o, dQ, dK and dV against their plain versions: each element within
# 2^-4·rms(want) + 2^-5·|want| and the tensor within 2^-7 relative L2
# (flash_attention.bf16_error says why). lse is f32 from the same max
# and a sum in another order: 1e-3 absolute.
LSE_TOL = 1e-3
SLICE = dict(b=4, h=16, h_kv=16, s_q=2048, s_k=2048, d=128, causal=True)
EDGE_SHAPES = [
    dict(b=2, h=16, h_kv=4, s_q=1024, s_k=1024, d=128, causal=True),
    dict(b=2, h=8, h_kv=8, s_q=1024, s_k=1024, d=128, causal=False),
    dict(b=2, h=8, h_kv=8, s_q=512, s_k=1024, d=128, causal=True),
    dict(b=2, h=8, h_kv=8, s_q=1024, s_k=512, d=128, causal=True),
    dict(b=2, h=4, h_kv=2, s_q=192, s_k=192, d=64, causal=True),
    dict(b=2, h=4, h_kv=4, s_q=100, s_k=100, d=64, causal=True),
    dict(b=1, h=4, h_kv=2, s_q=100, s_k=300, d=64, causal=False),
    # the wgmma kernels' 128-row tiles: one row past a tile, GQA across
    # several tiles, ragged s_q < s_k and s_q > s_k, MQA in one tile; dQ
    # with s_q not a multiple of 64 and GQA over two kv tiles
    dict(b=1, h=4, h_kv=4, s_q=129, s_k=129, d=128, causal=True),
    dict(b=2, h=8, h_kv=2, s_q=320, s_k=320, d=128, causal=True),
    dict(b=1, h=4, h_kv=4, s_q=200, s_k=456, d=64, causal=True),
    dict(b=1, h=4, h_kv=4, s_q=456, s_k=200, d=128, causal=True),
    dict(b=1, h=4, h_kv=1, s_q=64, s_k=64, d=64, causal=False),
    dict(b=1, h=8, h_kv=2, s_q=200, s_k=200, d=128, causal=True),
]
# head dims the kernels are not built for: zero-padded to the next of 64
# and 128 by the wrappers (GPT and BERT nano/tiny use 32, Llama tiny 16)
PADDED_SHAPES = [
    dict(b=1, h=4, h_kv=2, s_q=200, s_k=200, d=16, causal=True),
    dict(b=2, h=4, h_kv=4, s_q=130, s_k=130, d=32, causal=False),
    dict(b=1, h=4, h_kv=4, s_q=256, s_k=320, d=96, causal=True),
]
# the flash kernels as GPT-2 small (micro 12, seq 1024, causal),
# BERT-base (micro 32, seq 512, bidirectional), Llama-7B (micro 2, seq
# 2048, 32 heads of 128, causal), the Mixtral-width MoE (micro 4, 8 KV
# heads) and Llama-1B through the pipeline (microbatches of 2) call them
MODEL_SHAPES = {
    "gpt2": dict(b=12, h=12, h_kv=12, s_q=1024, s_k=1024, d=64,
                 causal=True),
    # GPT-2 small over a tensor axis of 2 (the sp phase's (d)): each rank
    # 6 of the 12 heads
    "gpt2_tp2": dict(b=12, h=6, h_kv=6, s_q=1024, s_k=1024, d=64,
                     causal=True),
    "bert": dict(b=32, h=12, h_kv=12, s_q=512, s_k=512, d=64,
                 causal=False),
    "llama7b": dict(b=2, h=32, h_kv=32, s_q=2048, s_k=2048, d=128,
                    causal=True),
    # Mixtral-8x7B's attention (32 heads of 128, GQA 4:1) at micro 4
    "mixtral": dict(b=4, h=32, h_kv=8, s_q=2048, s_k=2048, d=128,
                    causal=True),
    # the same over a tensor axis of 2 (the sp phase's (d)): each rank 16
    # of the 32 query heads over 4 of the 8 KV heads
    "mixtral_tp2": dict(b=4, h=16, h_kv=4, s_q=2048, s_k=2048, d=128,
                        causal=True),
    # Llama-1B's through the pipeline phase: microbatches of 2 rows
    "pipeline": dict(b=2, h=16, h_kv=16, s_q=2048, s_k=2048, d=128,
                     causal=True),
    # the ring's off-diagonal block of Llama-1B at seq 4096 over sequence
    # 2 (the sp phase): a shard's queries against an earlier shard's keys,
    # no mask
    "ring_block": dict(b=1, h=16, h_kv=16, s_q=2048, s_k=2048, d=128,
                       causal=False),
}
# kernels that must not spill: the warp-specialised ones, whose consumer
# warpgroups run at 240 registers under setmaxnreg
NO_SPILL = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
# A small bf16 Llama trained with attn_impl="flash" and "reference"
# from the same init. The loss barely moves in 3 steps, so the backward
# kernels are held by the gradients: the grad norm of every step, and
# each parameter's gradient of one step (relative L2), where the two
# attention paths differ only by bf16 rounding of o and of its gradient.
PARITY_LOSS_TOL = 2e-2
PARITY_GRAD_NORM_TOL = 1e-2
PARITY_GRAD_TOL = 2.0 ** -5
# RMSNorm at the Llama-1B slice shape (8 x 2048 rows of 2048), eps as the
# model passes it, and edge shapes (rows, dim, dtype): ragged rows, dim
# 64 and 4096, a dim that is not a multiple of 8, f32 x, and rows wide
# enough to need 2 and 4 chunks a thread. y and dx are held by
# flash_attention.bf16_error's rule (bf16) or norms.f32_error's (f32);
# rstd and dw by norms.f32_error's: within 1e-5 of the reference's RMS
# plus their own size. dw must be the same bits in two calls.
NORM_EPS = 1e-5
NORM_SLICE = (8 * 2048, 2048, torch.bfloat16)
# the norms as Llama-7B (micro 2) and the Mixtral-width MoE (micro 4)
# call them (x seq 2048 rows of 4096), and Llama-1B through the pipeline
# (2 × 2048 rows of 2048)
NORM_MODEL_SHAPES = {"llama7b": (2 * 2048, 4096, torch.bfloat16),
                     "mixtral": (4 * 2048, 4096, torch.bfloat16),
                     "pipeline": (2 * 2048, 2048, torch.bfloat16)}
NORM_EDGES = [
    (1000, 2048, torch.bfloat16), (4096, 64, torch.bfloat16),
    (512, 4096, torch.bfloat16), (300, 100, torch.bfloat16),
    (1000, 2048, torch.float32), (64, 12288, torch.bfloat16),
    (16, 30000, torch.float32),
]
# quantization: a Llama-1B gate_proj gradient, f32 (in, out), groups of
# 128 (43 a row); every code, scale and output equal to the plain
# versions' bit for bit.
QUANT_SHAPE = (2048, 5504)
# the checkpoint paths (resume, standalone, faults, failover, replan and
# the pipeline's resume) run Llama-1B at its full width cut to 4 of its 22
# layers: what they check (bits across a save and a restore, peer and int8
# restores, a kill, a drain, a hang, a master's death, a resize) does not
# depend on the depth, and their 15 GB checkpoints at 22 layers took most
# of the script's time (6.43 GB at 8 layers, 4.00 GB at 4)
CKPT_LAYERS = 4
# each wait on a phase's processes is about twice the phase's seconds on
# the card (measured runs of this script), so that a hang fails its phase
# with a message inside the script's 1200 s instead of running it out of
# time: the standalone agent, each faults launch, the failover drill, the
# replan agents, an example's run under its agent (models, moe) and the
# sp phase's ranks
STANDALONE_WAIT_S = 150.0
FAULTS_LAUNCH_WAIT_S = 240.0
FAILOVER_WAIT_S = 180.0
REPLAN_WAIT_S = 180.0
EXAMPLE_WAIT_S = 200.0
SP_WAIT_S = 240.0
# the whole script's budget on the card, about 20% under the contract's
# 1200 s, and the sp phase's part (d)'s share of it (printed beside the
# elapsed time): (d)'s five cases took 24.3 s with GPT-2 and BERT at 4
# layers on a host ≈15% slower than the one where its first two took
# 13.4 s at 12
SCRIPT_BUDGET_S = 950.0
SP_TENSOR_BUDGET_S = 30.0


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# device / build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch import native_build
    from dlrover_tpu_torch.ops import _build

    def native() -> float:
        t = time.monotonic()
        native_build.load_native()
        return time.monotonic() - t

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(LIBRARIES) + 1) as pool:
        # the operator's native reconciler (g++) beside the three nvcc
        # builds: it costs no time of its own
        native_s = pool.submit(native)
        libs = dict(zip(LIBRARIES, pool.map(_build.load, LIBRARIES)))
        native_s = native_s.result()
    log(f"build: {len(libs)} libraries in {time.monotonic() - t0:.1f} s")
    native_so = native_build.so_path()
    log(f"build: {native_so.parent.parent.name}/{native_so.parent.name}/"
        f"{native_so.name} (g++, native/*.cpp) in {native_s:.1f} s")
    spills = []
    for name, info in libs.items():
        log(f"build: {name}.cu in {info.build_seconds:.1f} s")
        for kernel, regs, spill in ptxas_report(info.ptxas_log):
            log(f"  ptxas: {kernel}: {regs} registers, {spill} bytes spilled")
            if spill and kernel.startswith(NO_SPILL):
                spills.append(kernel)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def ptxas_report(ptxas_log: str) -> list:
    """(kernel, registers, spill bytes stored + loaded) for each entry
    function of an ``nvcc -Xptxas=-v`` log, the kernel named by its
    template (``flash_fwd_kernel<128>``)."""
    import re

    rows, kernel, spill = [], None, 0
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", m.group(1))
            kernel = (f"{k.group(1)}<{k.group(2)}>" if k and k.group(2)
                      else k.group(1) if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spill))
            kernel, spill = None, 0
    return rows


def _counter_modules():
    from dlrover_tpu_torch.ops import flash_attention, norms, quantization

    return flash_attention, norms, quantization


def reset_counts() -> None:
    for module in _counter_modules():
        module.reset_launch_counts()


def read_counts() -> dict:
    counts = {}
    for module in _counter_modules():
        counts.update(module.launch_counts)
    return counts


def record(name: str, ms: float, plain_ms: float, bound_ms: float,
           bound_by: str, library_ms, max_abs_err: float, **extra) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def roofline(flops: float, peak_flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of operations over their peak and
    bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``: ``reps`` calls between two
    CUDA events, queued behind a device sleep so that the wrappers' host
    time (checks, allocations, the launch) overlaps the card's work
    instead of adding to it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def causal_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(q, k) score pairs the function needs: top-left causal keeps
    k <= q."""
    if not causal:
        return s_q * s_k
    return sum(min(i + 1, s_k) for i in range(s_q))


def bound(name: str, b, h, h_kv, s_q, s_k, d, causal) -> tuple:
    """(bound_ms, bound_by): the larger of FLOPs over the bf16 peak and
    bytes (each input read once, each output written once) over HBM
    rate."""
    pairs = b * h * causal_pairs(s_q, s_k, causal)
    q_el, kv_el, rows = b * h * s_q * d, b * h_kv * s_k * d, b * h * s_q
    if name == "flash_fwd":      # S = QKᵀ, O = PV
        flops = 4 * d * pairs
        nbytes = 2 * (2 * q_el + 2 * kv_el) + 4 * rows
    elif name == "flash_bwd_dq":  # S, dP = dO Vᵀ, dQ = dS K
        flops = 6 * d * pairs
        nbytes = 2 * (3 * q_el + 2 * kv_el) + 8 * rows
    else:                         # S, dP, dV = Pᵀ dO, dK = dSᵀ Q
        flops = 8 * d * pairs
        nbytes = 2 * (2 * q_el + 4 * kv_el) + 8 * rows
    return roofline(flops, PEAK_BF16_FLOPS, nbytes)


def _inputs(shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, h_kv, s_q, s_k, d = (shape[x] for x in
                               ("b", "h", "h_kv", "s_q", "s_k", "d"))

    def rnd(*dims):
        return torch.randn(*dims, generator=g, device="cuda").bfloat16()

    return (rnd(b, h, s_q, d), rnd(b, h_kv, s_k, d), rnd(b, h_kv, s_k, d),
            rnd(b, h, s_q, d))


def check_shape(shape, seed: int) -> tuple:
    """Kernel vs plain version at one shape: (max abs error of each
    output, the outputs beyond tolerance)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    causal = shape["causal"]
    q, k, v, do = _inputs(shape, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o2, _ = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    # both backward versions get the same lse and delta
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    pdq = fa.flash_bwd_dq_plain(q, k, v, do, plse, delta, causal)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, plse, delta, causal)
    errs, bad = {}, []
    for name, got, want in (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk),
                            ("dv", dv, pdv)):
        e = fa.bf16_error(got, want)
        errs[name] = e["max_abs"]
        if not fa.bf16_within_tolerance(e):
            bad.append(name)
        log(f"  {name} vs plain {shape}: max abs {e['max_abs']:.3g}, "
            f"rel L2 {e['rel_l2']:.3g} (limit {fa.BF16_REL_L2:.3g}), "
            f"worst element {e['worst']:.3g} of its allowance")
    errs["lse"] = (lse - plse).abs().max().item()
    if not errs["lse"] <= LSE_TOL:
        bad.append("lse")
    log(f"  lse vs plain {shape}: max abs {errs['lse']:.3g} (limit "
        f"{LSE_TOL})")
    same = {name: torch.equal(a, b) for name, a, b in (
        ("o", o, o2), ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
    bad += [f"{name} differs between two calls" for name, eq in same.items()
            if not eq]
    log(f"  o, dq, dk, dv bitwise equal in two calls: {same}")
    return errs, [f"{name} at {shape}" for name in bad]


def phase_kernels() -> list:
    return flash_kernels() + norm_kernels()


def time_flash(shape, seed: int) -> dict:
    """Each flash kernel's card time at ``shape`` beside its plain
    version's, its bound and the library yardstick: SDPA's forward, its
    backward alone (dQ, dK and dV in one call, the graph kept) and both
    (yardsticks only, never called on the path)."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    causal = shape["causal"]
    # SDPA takes fewer kv heads only when told (GQA)
    gqa = shape["h"] != shape["h_kv"]
    q, k, v, do = _inputs(shape, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    timings = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal)),
    }
    sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=gqa))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                        enable_gqa=gqa)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), do, retain_graph=True))

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=gqa), (qg, kg, vg), do)

    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    dims = [shape[x] for x in ("b", "h", "h_kv", "s_q", "s_k", "d",
                               "causal")]
    out = {}
    for name, (kernel, plain) in timings.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms, bound_by = bound(name, *dims)
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         library_fwd_bwd_ms=sdpa_fwd_bwd_ms)
        log(f"  {name} at {shape}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain "
            f"{plain_ms:.3f} ms, sdpa fwd {sdpa_fwd_ms:.4f} ms, sdpa bwd "
            f"alone {sdpa_bwd_ms:.4f} ms, sdpa fwd+bwd "
            f"{sdpa_fwd_bwd_ms:.4f} ms")
    del q, k, v, do, o, lse, delta, qg, kg, vg, og
    torch.cuda.empty_cache()
    return out


def _errors_of(errs: dict) -> dict:
    return {"flash_fwd": max(errs["o"], errs["lse"]),
            "flash_bwd_dq": errs["dq"],
            "flash_bwd_dkv": max(errs["dk"], errs["dv"])}


def flash_kernels() -> list:
    # every shape is checked and printed before a failure ends the phase
    bad = []
    for i, shape in enumerate(EDGE_SHAPES + PADDED_SHAPES):
        bad += check_shape(shape, seed=100 + i)[1]
    slice_errs, slice_bad = check_shape(SLICE, seed=1)
    bad += slice_bad
    model_errs = {}
    for i, (model, shape) in enumerate(MODEL_SHAPES.items()):
        model_errs[model], model_bad = check_shape(shape, seed=10 + i)
        bad += model_bad
    if bad:
        raise AssertionError(f"kernels beyond tolerance: {bad}")

    # times at the slice shape, then at the GPT-2 and BERT shapes
    times = time_flash(SLICE, seed=2)
    at_models = {model: time_flash(shape, seed=20 + i)
                 for i, (model, shape) in enumerate(MODEL_SHAPES.items())}
    records = []
    for name, t in times.items():
        extra = {f"at_{model}": dict(
            at_models[model][name],
            max_abs_err=_errors_of(model_errs[model])[name])
            for model in MODEL_SHAPES}
        records.append(record(
            name, t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"],
            t["library_ms"], _errors_of(slice_errs)[name],
            library_fwd_bwd_ms=t["library_fwd_bwd_ms"], **extra))
    return records


def _norm_inputs(rows: int, dim: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(rows, dim, generator=g, device="cuda")).to(dtype)
    w = 0.5 + torch.rand(dim, generator=g, device="cuda")
    dy = torch.randn(rows, dim, generator=g, device="cuda").to(dtype)
    return x, w, dy


def _norm_error(got, want) -> tuple:
    """(max abs error, within tolerance) under the rule of got's type."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norms

    if got.dtype == torch.bfloat16:
        e = fa.bf16_error(got, want)
        return e["max_abs"], fa.bf16_within_tolerance(e)
    e = norms.f32_error(got, want)
    return e["max_abs"], e["worst"] <= 1.0


def check_norm(rows: int, dim: int, dtype, seed: int) -> tuple:
    """Both norm kernels against their plain versions at one shape (the
    backward of both gets the plain rstd), and dw (and dx) the same bits
    in a second call: (max abs error of each output, what failed)."""
    from dlrover_tpu_torch.ops import norms

    x, w, dy = _norm_inputs(rows, dim, dtype, seed)
    y, rstd = norms.rms_fwd(x, w, NORM_EPS)
    torch.cuda.synchronize()
    py, prstd = norms.rms_fwd_plain(x, w, NORM_EPS)
    dx, dw = norms.rms_bwd(x, w, prstd, dy)
    dx2, dw2 = norms.rms_bwd(x, w, prstd, dy)
    torch.cuda.synchronize()
    pdx, pdw = norms.rms_bwd_plain(x, w, prstd, dy)
    errs, bad = {}, []
    for name, got, want in (("y", y, py), ("rstd", rstd, prstd),
                            ("dx", dx, pdx), ("dw", dw, pdw)):
        errs[name], ok = _norm_error(got, want)
        if not ok:
            bad.append(name)
    if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
        bad.append("dw/dx differ between two calls")
    shape = (rows, dim, str(dtype).replace("torch.", ""))
    log(f"  norm {shape}: max abs y {errs['y']:.3g}, rstd "
        f"{errs['rstd']:.3g}, dx {errs['dx']:.3g}, dw {errs['dw']:.3g}; "
        f"dw bitwise equal in two calls: {torch.equal(dw, dw2)}")
    return errs, [f"{name} at {shape}" for name in bad]


def norm_bound(name: str, rows: int, dim: int, esize: int) -> tuple:
    """Forward: x read, y written (each esize bytes), w and rstd; about 4
    f32 operations an element. Backward: x and g read, dx written, w,
    rstd and dw; about 10 f32 operations an element."""
    n = rows * dim
    if name == "rms_fwd":
        return roofline(4 * n, PEAK_F32_FLOPS,
                        2 * n * esize + 4 * dim + 4 * rows)
    return roofline(10 * n, PEAK_F32_FLOPS, 3 * n * esize + 4 * rows
                    + 8 * dim)


def time_norm(rows: int, dim: int, dtype, errs: dict, seed: int) -> dict:
    """Both norm kernels' card time at (rows, dim) beside their plain
    versions', their bounds and the library yardstick, F.rms_norm with
    the weight in x's type (its fused kernel takes one type): its
    forward, its backward alone (dx and dw, the graph kept) and both
    (yardsticks only, never called on the path)."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import norms

    x, w, dy = _norm_inputs(rows, dim, dtype, seed)
    _, rstd = norms.rms_fwd(x, w, NORM_EPS)
    xl = x.detach().clone().requires_grad_()
    wl = w.to(dtype).requires_grad_()
    lib_fwd_ms = time_ms(lambda: F.rms_norm(x, (dim,), wl, NORM_EPS))
    yl = F.rms_norm(xl, (dim,), wl, NORM_EPS)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        yl, (xl, wl), dy, retain_graph=True))
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        F.rms_norm(xl, (dim,), wl, NORM_EPS), (xl, wl), dy))
    timings = {
        "rms_fwd": (lambda: norms.rms_fwd(x, w, NORM_EPS),
                    lambda: norms.rms_fwd_plain(x, w, NORM_EPS), lib_fwd_ms,
                    max(errs["y"], errs["rstd"])),
        "rms_bwd": (lambda: norms.rms_bwd(x, w, rstd, dy),
                    lambda: norms.rms_bwd_plain(x, w, rstd, dy), lib_bwd_ms,
                    max(errs["dx"], errs["dw"])),
    }
    out = {}
    for name, (kernel, plain, library_ms, err) in timings.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms, bound_by = norm_bound(name, rows, dim, x.element_size())
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         library_fwd_bwd_ms=lib_fwd_bwd_ms, max_abs_err=err)
        log(f"  {name} at {(rows, dim)}: {ms:.4f} ms (bound {bound_ms:.4f} "
            f"ms by {bound_by}, {bound_ms / ms:.1%} of it), plain "
            f"{plain_ms:.3f} ms, F.rms_norm {library_ms:.4f} ms, F.rms_norm "
            f"fwd+bwd {lib_fwd_bwd_ms:.4f} ms")
    del x, w, dy, rstd, xl, wl, yl
    torch.cuda.empty_cache()
    return out


def norm_kernels() -> list:
    bad = []
    for i, shape in enumerate(NORM_EDGES):
        bad += check_norm(*shape, seed=200 + i)[1]
    slice_errs, slice_bad = check_norm(*NORM_SLICE, seed=4)
    model_errs = {}
    for i, (model, shape) in enumerate(NORM_MODEL_SHAPES.items()):
        model_errs[model], model_bad = check_norm(*shape, seed=40 + i)
        bad += model_bad
    if bad + slice_bad:
        raise AssertionError(f"norm kernels beyond tolerance: "
                             f"{bad + slice_bad}")
    times = time_norm(*NORM_SLICE, slice_errs, seed=5)
    at_models = {model: time_norm(*shape, model_errs[model], seed=50 + i)
                 for i, (model, shape) in enumerate(NORM_MODEL_SHAPES.items())}
    records = []
    for name, t in times.items():
        records.append(record(
            name, t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"],
            t["library_ms"], t["max_abs_err"],
            library_fwd_bwd_ms=t["library_fwd_bwd_ms"],
            **{f"at_{model}": at_models[model][name]
               for model in NORM_MODEL_SHAPES}))
    return records


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _quant_input(rows: int, cols: int, group: int, seed: int):
    """f32 groups of very different sizes (10^-3 to 10^1 a row), with an
    all-zero group and two tie groups in row 0: absmax 127/8 (or 7/8)
    makes the scale 1/8 and the inverse 8 exactly, and values (k+½)/8
    then land x·inv on k+½, where rounding half to even and half away
    from zero differ."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, cols, generator=g, device="cuda")
    x *= 10.0 ** (4 * torch.rand(rows, 1, generator=g, device="cuda") - 3)
    x[0, :group] = 0
    for i, qmax in ((1, 127), (2, 7)):
        k = torch.arange(group - 1, device="cuda")
        half = (k % qmax + 0.5) / 8
        x[0, i * group] = qmax / 8
        x[0, i * group + 1:(i + 1) * group] = torch.where(k % 2 == 1, -half,
                                                          half)
    return x


def _quant_path(x, xb, x8, x6, chunks) -> dict:
    """The quantization API as a user calls it, on the gate_proj
    gradient (int8, int4, f32 and bf16 outputs), a bf16 input, groups of
    8 and of 6, the swizzled layout over 4 partners and a reduction of 4
    chunks; every output by name."""
    from dlrover_tpu_torch.ops import quantization as qz

    out = {}

    def both(name, pair):
        out[f"q_{name}"], out[f"s_{name}"] = pair
        return pair

    for bits in (8, 4):
        q, s = both(f"int{bits}", qz.quantize(x, bits))
        out[f"deq_int{bits}"] = qz.dequantize(q, s, bits)
        out[f"deq_int{bits}_bf16"] = qz.dequantize(q, s, bits,
                                                   torch.bfloat16)
    q, s = both("bf16_in", qz.quantize(xb))
    out["deq_bf16_in"] = qz.dequantize(q, s, dtype=torch.bfloat16)
    q, s = both("group8", qz.quantize(x8, 4, group_size=8))
    out["deq_group8"] = qz.dequantize(q, s, 4)
    # a group that is not a multiple of 4 takes the kernels' one-wide path
    q, s = both("group6", qz.quantize(x6, 8, group_size=6))
    out["deq_group6"] = qz.dequantize(q, s, dtype=torch.bfloat16)
    q, s = both("swizzled", qz.swizzled_quantize(x, 4))
    out["unswizzled"] = qz.unswizzle_dequantize(q, s, x.shape)
    pairs = [qz.quantize(c) for c in chunks]
    both("reduced", qz.quant_reduce(torch.stack([a for a, _ in pairs]),
                                    torch.stack([b for _, b in pairs])))
    return out


def phase_quant() -> list:
    """The quantization path on the card, its launches counted, then each
    output against the same API run on the CPU, where every kernel is its
    plain version (the packing, swizzle and sum code is shared)."""
    from dlrover_tpu_torch.ops import quantization as qz

    rows, cols = QUANT_SHAPE
    x = _quant_input(rows, cols, 128, seed=6)
    xb = _quant_input(rows, cols, 128, seed=7).bfloat16()
    x8 = _quant_input(256, 1024, 8, seed=8)
    x6 = _quant_input(256, 1032, 6, seed=9).bfloat16()
    chunks = [_quant_input(rows, cols, 128, seed=10 + i) for i in range(4)]
    reset_counts()
    got = _quant_path(x, xb, x8, x6, chunks)
    torch.cuda.synchronize()
    launches = read_counts()
    want = _quant_path(x.cpu(), xb.cpu(), x8.cpu(), x6.cpu(),
                       [c.cpu() for c in chunks])
    differ = [name for name in want
              if not torch.equal(got[name].cpu(), want[name])]
    log(f"quant: launches {launches}; {len(want)} outputs compared bit for "
        f"bit with the plain versions, differing: {differ or 'none'}")
    if differ:
        raise AssertionError(f"quantization outputs differ: {differ}")
    if not (launches["quantize"] and launches["dequantize"]):
        raise AssertionError(f"quant path launched {launches}")

    # kernel against plain version at the gate_proj shape, int8
    x2 = x.reshape(-1, 128)
    q2, s2 = qz.quantize_rows(x2, 127)
    pq, ps = qz.quantize_plain(x2, 127)
    deq = qz.dequantize_rows(pq, ps)
    torch.cuda.synchronize()
    pdeq = qz.dequantize_plain(pq, ps)
    errs = {"quantize": max((q2.int() - pq.int()).abs().max().item(),
                            (s2 - ps).abs().max().item()),
            "dequantize": (deq - pdeq).abs().max().item()}
    if max(errs.values()) != 0 or not (torch.equal(q2, pq)
                                       and torch.equal(deq, pdeq)):
        raise AssertionError(f"quantization kernels differ: {errs}")
    n = x2.numel()
    # yardstick only, never called on the path: torch.mul of int8 codes
    # and f32 scales promotes to f32 and is dequantize in one call. No
    # single PyTorch call computes groupwise absmax quantization.
    timings = {
        "quantize": (lambda: qz.quantize_rows(x2, 127),
                     lambda: qz.quantize_plain(x2, 127), None,
                     roofline(4 * n, PEAK_F32_FLOPS, 4 * n + n + 4 * len(x2))),
        "dequantize": (lambda: qz.dequantize_rows(pq, ps),
                       lambda: qz.dequantize_plain(pq, ps),
                       lambda: torch.mul(pq, ps),
                       roofline(n, PEAK_F32_FLOPS, n + 4 * len(x2) + 4 * n)),
    }
    records = []
    for name, (kernel, plain, library, bounds) in timings.items():
        bound_ms, bound_by = bounds
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library) if library else None
        rec = record(name, ms, plain_ms, bound_ms, bound_by, library_ms,
                     errs[name])
        rec["launches"] = launches[name]
        records.append(rec)
        log(f"  {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain {plain_ms:.3f}"
            f" ms, " + (f"torch.mul {library_ms:.4f} ms" if library
                        else "no single PyTorch call"))
    del x, xb, x8, x6, chunks, got, x2, q2, s2, pq, ps, deq
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def ckpt_config():
    """The checkpoint paths' model: Llama-1B in the JAX headline
    configuration, ``CKPT_LAYERS`` deep."""
    import dataclasses

    from dlrover_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(
        LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                             norm_impl="fused", embed_impl="gather"),
        num_layers=CKPT_LAYERS)


def _adamw(params):
    # optax.adamw(3e-4, weight_decay=0.1)
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def _train(cfg, global_batch: int, steps: int, max_micro: int,
           profile_out: str = "", model_cls=None, loss_fn=None,
           seq: int = 0, same_targets: bool = False,
           optimizer_factory=None, trainer=None, after=None,
           data_source=None):
    """Train ``model_cls(cfg)`` (Llama by default, with its loss)
    through ElasticTrainLoop on the synthetic corpus at ``seq`` (the
    config's ``max_seq_len`` by default) from seed 0: (the history, the
    kernel launches of the run). ``same_targets`` scores each token
    against itself (a masked LM's dense targets). AdamW unless
    ``optimizer_factory``; ``trainer`` (the streaming one) takes the
    dense trainer's place. ``after(state, data)``, when given, is called
    with the trained state and the batches to come, after the launches
    are read. ``data_source``: (tokens, targets) batches in the synthetic
    corpus's place (no sampler then)."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    seq = seq or cfg.max_seq_len
    loop = ElasticTrainLoop(
        functools.partial(model_cls or Llama, cfg),
        optimizer_factory or _adamw, loss_fn or cross_entropy_loss,
        TrainLoopConfig(global_batch=global_batch, seq_len=seq,
                        max_micro_per_replica=max_micro, max_steps=steps,
                        report_interval_steps=0), trainer=trainer)
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, shuffle=True,
                                        seed=0)
    state, start = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(cfg.vocab_size), sampler, global_batch,
                   seq)
    if data_source is not None:
        data, sampler = data_source, None
    if same_targets:
        data = ((tokens, tokens) for tokens, _ in data)
    state, metrics = loop.run(state, data, start_step=start,
                              sampler=sampler)
    # the main path's launches, read before any profiled step adds more
    launches = read_counts()
    if after is not None:
        after(state, data)
    if profile_out:
        loop.config.max_steps = 1
        profile_step(lambda: loop.run(state, data, sampler=sampler),
                     profile_out)
    loop.close()
    del state
    return metrics["history"], launches


def _category(name: str) -> str:
    lowered = name.lower()
    for key, cat in (("layer_norm", "layer norm"),
                     ("rms_fwd", "rms_fwd kernel"),
                     ("rms_bwd", "rms_bwd kernel"),
                     ("rms_dw_sum", "rms_bwd kernel"),
                     ("flash_fwd", "flash fwd kernel"),
                     ("flash_bwd_dq", "flash dQ kernel"),
                     ("flash_bwd_dkv", "flash dK/dV kernel"),
                     ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
                     ("sm90", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
                     ("multi_tensor", "optimizer (foreach)"),
                     ("reduce", "reductions"), ("softmax", "softmax"),
                     ("elementwise", "elementwise"), ("catarray", "concat"),
                     ("index", "gather/scatter"), ("memcpy", "copies"),
                     ("memset", "copies")):
        if key in lowered:
            return cat
    return "other"


def profile_step(run_step, out_path: str) -> None:
    """One training step under torch.profiler: device time by kernel
    category, the device's busy share of the step's wall time, and the
    full table in ``out_path``."""
    import os

    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # kernel rows only: operator rows and annotated ranges (the
    # optimizer step) repeat their kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")
              and e.key != "Command Buffer Full"]
    by_cat: dict = {}
    for e in events:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(by_cat.values())
    log(f"profile: step wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
        f" ({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"  profile: {cat:24s} {ms:9.2f} ms  {ms / busy_ms:6.1%}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))


def _one_step_grads(cfg, tokens, targets, model_cls=None,
                    loss_fn=None) -> dict:
    """Each parameter's f32 gradient of one loss, from the seed-0 init
    the training runs start from (Llama and its loss by default)."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss

    model = (model_cls or Llama)(cfg, seed=0)
    (loss_fn or cross_entropy_loss)(model(tokens), targets).backward()
    return {n: p.grad.float() for n, p in model.named_parameters()
            if p.grad is not None}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def _expected_launches(cfg, micro_steps: int, recompute: bool = False
                       ) -> dict:
    """Each kernel's launches over ``micro_steps`` forward+backward passes
    of ``cfg``: a flash kernel once a layer, an RMSNorm kernel at each of
    a Llama's 2·L+1 norms, nothing of the quantization pair (GPT and
    BERT normalise with LayerNorm, plain PyTorch as in the JAX
    package). Where each block's forward runs again in the backward
    (``cfg.remat`` under any policy, or ``recompute``: the streaming
    step), the forward kernels of the blocks launch twice: flash_fwd
    2·L, rms_fwd 4·L+1 (the final norm once)."""
    layers = getattr(cfg, "num_layers", 0) or cfg.n_layer
    again = recompute or getattr(cfg, "remat", False)
    flash = layers * micro_steps if cfg.attn_impl == "flash" else 0
    norm = ((2 * layers + 1) * micro_steps
            if getattr(cfg, "norm_impl", "") == "fused" else 0)
    return {"flash_fwd": 2 * flash if again else flash,
            "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
            "rms_fwd": norm + 2 * layers * micro_steps
            if again and norm else norm,
            "rms_bwd": norm, "quantize": 0, "dequantize": 0}


def _compare_runs(what: str, a: str, b: str, losses, grad_norms, grads,
                  show) -> None:
    """Losses, per-step grad norms and one step's gradients of run a
    against run b, within the PARITY_* limits; ``show`` names gradients
    to print besides the four worst."""
    diffs = [abs(x - y) for x, y in zip(losses[a], losses[b])]
    norm_diffs = [abs(x - y) / y for x, y in zip(grad_norms[a],
                                                 grad_norms[b])]
    grad_errs = {n: _rel_l2(grads[a][n], grads[b][n]) for n in grads[b]}
    worst = sorted(grad_errs, key=grad_errs.get, reverse=True)
    log(f"parity ({what}): {a} {losses[a]} {b} {losses[b]} max |diff| "
        f"{max(diffs):.3g} (tolerance {PARITY_LOSS_TOL})")
    log(f"parity ({what}): grad norms {a} {grad_norms[a]} {b} "
        f"{grad_norms[b]} max relative diff {max(norm_diffs):.3g} "
        f"(tolerance {PARITY_GRAD_NORM_TOL})")
    log(f"parity ({what}): one step's gradients, relative L2 (tolerance "
        f"{PARITY_GRAD_TOL}): worst "
        + ", ".join(f"{n} {grad_errs[n]:.3g}" for n in worst[:4]) + "; "
        + ", ".join(f"{n} {grad_errs[n]:.3g}" for n in show))
    if len(diffs) != 3 or not max(diffs) <= PARITY_LOSS_TOL:
        raise AssertionError(f"{what}: training losses disagree")
    if not max(norm_diffs) <= PARITY_GRAD_NORM_TOL:
        raise AssertionError(f"{what}: grad norms disagree")
    if not grad_errs[worst[0]] <= PARITY_GRAD_TOL:
        raise AssertionError(f"{what}: gradients disagree: {worst[0]} "
                             f"{grad_errs[worst[0]]}")


def phase_parity() -> None:
    """A small Llama from one init through three paths: flash attention
    with the plain norm against plain attention (the flash kernels), and
    flash attention with the fused norm against the plain norm (the norm
    kernels; the *_norm.weight gradients are rms_bwd's dw)."""
    from dlrover_tpu_torch.models.llama import LlamaConfig

    g = torch.Generator(device="cuda").manual_seed(3)
    tokens, targets = (torch.randint(0, 1024, (4, 256), generator=g,
                                     device="cuda") for _ in range(2))
    losses, grad_norms, grads = {}, {}, {}
    for attn, norm in (("flash", "reference"), ("reference", "reference"),
                       ("flash", "fused")):
        run = f"{attn}/{norm}"
        cfg = LlamaConfig(vocab_size=1024, hidden_size=512,
                          intermediate_size=1408, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_seq_len=256, attn_impl=attn,
                          norm_impl=norm, embed_impl="gather")
        grads[run] = _one_step_grads(cfg, tokens, targets)
        reset_counts()
        hist, launches = _train(cfg, global_batch=4, steps=3, max_micro=4)
        losses[run] = [r["loss"] for r in hist]
        grad_norms[run] = [r["grad_norm"] for r in hist]
        want = _expected_launches(cfg, len(hist))
        if launches != want:
            raise AssertionError(f"{run} parity run launches {launches}, "
                                 f"want {want}")
    _compare_runs("attention", "flash/reference", "reference/reference",
                  losses, grad_norms, grads,
                  [f"layer_0.attn.{p}_proj.kernel" for p in "qkv"])
    _compare_runs("norm", "flash/fused", "flash/reference", losses,
                  grad_norms, grads,
                  sorted(n for n in grads["flash/fused"] if "norm" in n))
    del grads
    torch.cuda.empty_cache()


def phase_llama1b(warmup: int = 2, timed: int = 5,
                  profile_out: str = "") -> dict:
    from dlrover_tpu_torch.models.llama import LlamaConfig

    # the JAX headline configuration (bench.py:400-412): Llama-1B, flash
    # attention, fused norm, sequences of 2048, micro batch 8, AdamW. f32
    # params, grads and both Adam moments take ≈20 GB of the card's 80
    micro = 8
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, launches = _train(cfg, global_batch=micro, steps=warmup + timed,
                            max_micro=micro, profile_out=profile_out)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in hist:
        log(f"  llama1b step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != warmup + timed:
        raise AssertionError(f"ran {len(hist)} steps")
    if not all(math.isfinite(r["loss"]) for r in hist):
        raise AssertionError("non-finite loss")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {hist[0]['loss']} is not near "
                             f"ln(vocab) = {math.log(cfg.vocab_size):.3f}")
    want = _expected_launches(cfg, len(hist))
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({len(hist)}"
                             f" steps of one micro-batch)")
    timed_hist = hist[warmup:]
    step_s = sum(r["step_time_s"] for r in timed_hist) / timed
    median_ms = statistics.median(r["step_time_s"] for r in timed_hist) * 1e3
    tokens_per_s = micro * cfg.max_seq_len / step_s
    mfu = statistics.mean(r["mfu"] for r in timed_hist)
    result = {"params_b": cfg.param_count() / 1e9, "micro_batch": micro,
              "seq": cfg.max_seq_len, "step_ms": step_s * 1e3,
              "step_median_ms": median_ms,
              "tokens_per_s": tokens_per_s, "mfu": mfu,
              "peak_mem_gb": peak_gb, "launches_per_step": {
                  n: c / len(hist) for n, c in launches.items()},
              "losses": [r["loss"] for r in hist]}
    log(f"llama1b: {json.dumps(result)}")
    return launches, result


# ---------------------------------------------------------------------------
# auto: auto_accelerate lowers Llama-1B from a strategy, a coworker feeds it
# through the shared-memory ring and the coworker service, and the search
# dry-runs candidates on the card
# ---------------------------------------------------------------------------

AUTO_MICRO, AUTO_SEQ = 8, 2048
# (a): the llama1b phase's first steps, lowered from a strategy
AUTO_STEPS = 3
# (b): steps fed through the ring, then through the coworker service
AUTO_RING_STEPS, AUTO_SERVICE_STEPS = 3, 3
# (c): the search at micro 2, capped by its own knob: the bo search spends
# DLROVER_TPU_SEARCH_BUDGET dry runs of 1 warm-up + 3 timed steps (the
# planner's 8 one-device candidates outgrow it, so "auto" picks bo)
AUTO_SEARCH_MICRO, AUTO_SEARCH_BUDGET = 2, 4
AUTO_SEARCH_DRY_STEPS = 1 + 3
AUTO_SEARCH_TRAIN_STEPS = 2
# the allocator's level after the search against before it
AUTO_MEMORY_SLACK = 64 << 20

# the coworker: attaches the trainer's ring, pushes AUTO_RING_STEPS
# batches of the synthetic corpus (the llama1b phase's sampler and data)
# with their CRCs, closes the ring, then pushes AUTO_SERVICE_STEPS more
# through a CoworkerClient. It imports no torch.
COWORKER = r'''
import json, sys, time
t0 = time.monotonic()
from dlrover_tpu_torch.data.shm_ring import ShmDataContext
from dlrover_tpu_torch.ops.host_ops import crc32
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus
names, addr, vocab, micro, seq, ring_steps, service_steps = json.loads(
    sys.argv[1])
ctx = ShmDataContext.attach(names)
started_s = time.monotonic() - t0
sampler = ElasticDistributedSampler(dataset_size=10 ** 6, shuffle=True,
                                    seed=0)
data = batches(synthetic_corpus(vocab), sampler, micro, seq)

def stamped(tokens, targets):
    tokens, targets = tokens.astype("int64"), targets.astype("int64")
    return {"tokens": tokens, "targets": targets,
            "crc": [crc32(tokens), crc32(targets)]}

for _ in range(ring_steps):
    ctx.push(stamped(*next(data)))
ctx.close_producers()
from dlrover_tpu_torch.data.coworker import CoworkerClient
client = CoworkerClient(addr)
for _ in range(service_steps):
    if not client.push_batch(stamped(*next(data))):
        raise SystemExit("the coworker service refused a batch")
client.close()
print(json.dumps({"started_s": started_s,
                  "torch_imported": "torch" in sys.modules}), flush=True)
'''


def _sum_counts(*counts) -> dict:
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def _auto_lowering(smi: str, llama1b: dict, steps: int) -> tuple:
    """(a) ``["amp", "module_replace"]`` on Llama-1B written with the
    plain attention: the lowered config is the llama1b phase's, and its
    first AUTO_STEPS losses are that phase's bit for bit (all of the
    steps both ran). Run for ``steps``: its (loss, grad_norm) become the
    uninterrupted in-process reference of that depth (``_REFERENCE``),
    which the observe phase would otherwise train again."""
    import numpy as np

    from dlrover_tpu_torch.auto import auto_accelerate
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )

    want_cfg = LlamaConfig.llama_1b(max_seq_len=AUTO_SEQ, attn_impl="flash",
                                    norm_impl="fused", embed_impl="gather")
    base = LlamaConfig.llama_1b(max_seq_len=AUTO_SEQ, attn_impl="reference",
                                norm_impl="fused", embed_impl="gather")
    if llama1b.get("losses"):
        ref, ref_from = llama1b["losses"][:steps], "the llama1b phase"
        ref_ms = llama1b["step_median_ms"]
    else:
        ref = [loss for loss, _ in _reference_prefix(want_cfg, AUTO_STEPS)]
        ref_from, ref_ms = "an in-process direct build", "not measured"
    t0 = time.monotonic()
    result = auto_accelerate(
        functools.partial(Llama, base), optim_factory=lambda: _adamw,
        loss_fn=cross_entropy_loss,
        sample_batch=np.zeros((AUTO_MICRO, AUTO_SEQ), np.int64),
        strategy=["amp", "module_replace"], micro_batch=AUTO_MICRO)
    lowered = result.context.model_config()
    if lowered != want_cfg:
        raise AssertionError(f"auto (a) lowered {lowered}, want the llama1b "
                             f"phase's {want_cfg}")
    lower_s = time.monotonic() - t0
    reset_counts()
    hist, launches = _train(lowered, AUTO_MICRO, steps, AUTO_MICRO,
                            trainer=result.trainer)
    losses = [r["loss"] for r in hist]
    steps_ms = [r["step_time_s"] * 1e3 for r in hist]
    out = {"strategy": result.strategy, "lower_s": lower_s,
           "mesh": result.mesh.shape,
           "accum_micro": [result.trainer.accum_steps,
                           result.trainer.micro_batch],
           "steps": steps, "losses": losses[:len(ref)],
           "reference": ref_from, "steps_ms": steps_ms[:AUTO_STEPS],
           "step_median_ms_after_the_first_2": statistics.median(
               steps_ms[2:] or steps_ms),
           "llama1b_step_median_ms": ref_ms,
           "launches": launches,
           "want_launches": _expected_launches(lowered, steps)}
    log(f"auto (a): {json.dumps(out)} ({smi})")
    if len(ref) < AUTO_STEPS or losses[:len(ref)] != ref:
        raise AssertionError(f"auto (a) losses {losses[:len(ref)]}, "
                             f"{ref_from}'s {ref}")
    if steps > len(ref):
        _REFERENCE[("long", lowered.num_layers)] = [
            (r["loss"], r["grad_norm"]) for r in hist]
    del result
    _free_memory()
    return out, launches


def _auto_coworker(smi: str, repo: str) -> tuple:
    """(b) the default strategy fed by a coworker: AUTO_RING_STEPS through
    the shared-memory ring, AUTO_SERVICE_STEPS through the coworker
    service, each batch's CRC recomputed on the card by the checksum op;
    the losses those of the same steps fed the same batches directly."""
    import os

    import numpy as np

    from dlrover_tpu_torch.auto import auto_accelerate
    from dlrover_tpu_torch.data.coworker import CoworkerDataService
    from dlrover_tpu_torch.data.prefetch import PrefetchAutoTuner
    from dlrover_tpu_torch.data.shm_ring import ShmDataContext
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.ops.host_ops import checksum
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    steps = AUTO_RING_STEPS + AUTO_SERVICE_STEPS
    base = LlamaConfig.llama_1b(max_seq_len=AUTO_SEQ, attn_impl="reference",
                                norm_impl="fused", embed_impl="gather")

    def lowered():
        return auto_accelerate(
            functools.partial(Llama, base), optim_factory=lambda: _adamw,
            loss_fn=cross_entropy_loss,
            sample_batch=np.zeros((AUTO_MICRO, AUTO_SEQ), np.int64),
            micro_batch=AUTO_MICRO)

    result = lowered()
    cfg = result.context.model_config()
    capacity = PrefetchAutoTuner().ring_capacity()
    crcs, out = [], {"strategy": result.strategy,
                     "param_dtype": str(cfg.param_dtype),
                     "attn_impl": cfg.attn_impl, "ring_capacity": capacity}
    service = CoworkerDataService(capacity=8, port=0, host="127.0.0.1")
    service.start()
    proc = None
    try:
        with ShmDataContext(num_rings=1, capacity=capacity) as ctx:
            t_spawn = time.monotonic()
            proc = subprocess.Popen(
                [sys.executable, "-c", COWORKER, json.dumps([
                    ctx.ring_names, f"127.0.0.1:{service.port}",
                    cfg.vocab_size, AUTO_MICRO, AUTO_SEQ, AUTO_RING_STEPS,
                    AUTO_SERVICE_STEPS])],
                cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                stdout=subprocess.PIPE, text=True)
            first = {}

            def fed():
                for source, batches_of in (
                        ("ring", ctx.batches(timeout_s=120)),
                        ("service", service.batches(timeout_s=120))):
                    for batch in batches_of:
                        first.setdefault(source, time.monotonic() - t_spawn)
                        tokens = torch.from_numpy(batch["tokens"]).cuda()
                        targets = torch.from_numpy(batch["targets"]).cuda()
                        got = [int(checksum(tokens)), int(checksum(targets))]
                        crcs.append({"source": source, "stamped":
                                     batch["crc"], "on_card": got})
                        if got != batch["crc"]:
                            raise AssertionError(f"auto (b) CRC {got} on the "
                                                 f"card, {batch['crc']} "
                                                 f"stamped")
                        yield tokens, targets

            reset_counts()
            hist, launches = _train(cfg, AUTO_MICRO, steps, AUTO_MICRO,
                                    trainer=result.trainer,
                                    data_source=fed())
            report, _ = proc.communicate(timeout=120)
            if proc.returncode != 0:
                raise AssertionError(f"auto (b) coworker exited "
                                     f"{proc.returncode}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        service.stop()
    del result
    _free_memory()
    coworker = json.loads(report.strip().splitlines()[-1])
    # the same steps fed the same batches directly
    direct = lowered()
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, shuffle=True,
                                        seed=0)
    ref, _ = _train(cfg, AUTO_MICRO, steps, AUTO_MICRO,
                    trainer=direct.trainer, data_source=batches(
                        synthetic_corpus(cfg.vocab_size), sampler,
                        AUTO_MICRO, AUTO_SEQ))
    del direct
    _free_memory()
    losses = [r["loss"] for r in hist]
    out.update({"coworker_started_s": coworker["started_s"],
                "coworker_imported_torch": coworker["torch_imported"],
                "first_batch_after_spawn_s": first, "crcs": crcs,
                "losses": losses,
                "direct_losses": [r["loss"] for r in ref],
                "steps_ms": [r["step_time_s"] * 1e3 for r in hist],
                "launches": launches,
                "want_launches": _expected_launches(cfg, steps)})
    log(f"auto (b): {json.dumps(out)} ({smi})")
    if coworker["torch_imported"]:
        raise AssertionError("auto (b): the coworker imported torch")
    if len(crcs) != steps or [c["source"] for c in crcs] != (
            ["ring"] * AUTO_RING_STEPS + ["service"] * AUTO_SERVICE_STEPS):
        raise AssertionError(f"auto (b): {len(crcs)} batches checked")
    if losses != out["direct_losses"]:
        raise AssertionError(f"auto (b) losses {losses}, fed directly "
                             f"{out['direct_losses']}")
    return out, launches


def _auto_search(smi: str) -> tuple:
    """(c) strategy="auto" at micro 2 under DLROVER_TPU_SEARCH_BUDGET: every
    candidate's steps/s or error, the pick trains, no kernel error was
    swallowed and no fallback reached, and the allocator comes back."""
    import os

    import numpy as np

    from dlrover_tpu_torch.auto import ModelContext, accelerate
    from dlrover_tpu_torch.auto.engine import acceleration_engine as engine
    from dlrover_tpu_torch.auto.engine.dry_runner import is_kernel_error
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )

    base = LlamaConfig.llama_1b(max_seq_len=AUTO_SEQ, attn_impl="reference",
                                norm_impl="fused", embed_impl="gather")
    factory = functools.partial(Llama, base)
    sample = np.zeros((AUTO_SEARCH_MICRO, AUTO_SEQ), np.int64)

    def lowered_config(strategy):
        ctx = accelerate.apply_strategy(
            ModelContext(factory, sample_batch=sample), strategy)
        accelerate._edit_model(ctx, accelerate.plan_mesh_spec(ctx))
        return ctx.model_config()

    runs = []
    real_dry_run, real_fallback = engine.dry_run, engine._fallback_default

    def recorded(context, strategy, warmup=0, steps=0):
        t0 = time.monotonic()
        try:
            speed, err = real_dry_run(context, strategy, warmup, steps)
        except Exception as e:
            runs.append({"strategy": [n for n, _ in strategy],
                         "raised": repr(e)[:300]})
            raise
        runs.append({"strategy": [n for n, _ in strategy],
                     "steps_per_s": speed if err == "" else None,
                     "error": err[:300], "s": time.monotonic() - t0,
                     "kernel_error": bool(err) and is_kernel_error(
                         RuntimeError(err)),
                     "config": lowered_config(strategy)})
        return speed, err

    def no_fallback(context):
        raise AssertionError("auto (c): every candidate failed; the search "
                             "reached its fallback")

    saved = os.environ.get("DLROVER_TPU_SEARCH_BUDGET")
    os.environ["DLROVER_TPU_SEARCH_BUDGET"] = str(AUTO_SEARCH_BUDGET)
    engine.dry_run, engine._fallback_default = recorded, no_fallback
    _free_memory()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.monotonic()
    try:
        result = accelerate.auto_accelerate(
            factory, optim_factory=lambda: _adamw,
            loss_fn=cross_entropy_loss, sample_batch=sample, strategy="auto",
            micro_batch=AUTO_SEARCH_MICRO)
    finally:
        engine.dry_run, engine._fallback_default = (real_dry_run,
                                                    real_fallback)
        if saved is None:
            os.environ.pop("DLROVER_TPU_SEARCH_BUDGET", None)
        else:
            os.environ["DLROVER_TPU_SEARCH_BUDGET"] = saved
    search_s = time.monotonic() - t0
    search_launches = read_counts()
    # the trainer of the pick is built but holds nothing until its init
    after = torch.cuda.memory_allocated()
    picked = result.context.model_config()
    strategy = [n for n, _ in result.strategy]
    reset_counts()
    hist, train_launches = _train(
        picked, AUTO_SEARCH_MICRO, AUTO_SEARCH_TRAIN_STEPS,
        AUTO_SEARCH_MICRO, trainer=result.trainer)
    del result
    _free_memory()
    ok = [r for r in runs if r.get("error") == ""]
    want = _sum_counts(
        *[_expected_launches(r["config"], AUTO_SEARCH_DRY_STEPS)
          for r in ok],
        _expected_launches(picked, AUTO_SEARCH_TRAIN_STEPS))
    launches = _sum_counts(search_launches, train_launches)
    out = {"budget": AUTO_SEARCH_BUDGET, "micro_batch": AUTO_SEARCH_MICRO,
           "dry_runs": [{k: v for k, v in r.items() if k != "config"}
                        for r in runs],
           "picked": strategy, "search_s": search_s,
           "memory_before_mib": before / 2 ** 20,
           "memory_after_mib": after / 2 ** 20,
           "pick_losses": [r["loss"] for r in hist],
           "launches": launches, "want_launches": want}
    log(f"auto (c): {json.dumps(out)} ({smi})")
    for r in runs:
        log(f"  auto (c) candidate {r['strategy']}: "
            + (f"{r['steps_per_s']:.3f} steps/s" if r.get("error") == ""
               else f"error {r.get('error') or r.get('raised')}"))
    if not runs or len(runs) > AUTO_SEARCH_BUDGET:
        raise AssertionError(f"auto (c): {len(runs)} dry runs, want 1 to "
                             f"{AUTO_SEARCH_BUDGET}")
    if any(r.get("kernel_error") or "raised" in r for r in runs):
        raise AssertionError(f"auto (c): a candidate failed on a kernel: "
                             f"{out['dry_runs']}")
    if not (len(hist) == AUTO_SEARCH_TRAIN_STEPS
            and all(math.isfinite(r["loss"]) for r in hist)):
        raise AssertionError(f"auto (c): the pick {strategy} did not train: "
                             f"{out['pick_losses']}")
    if abs(after - before) > AUTO_MEMORY_SLACK:
        raise AssertionError(f"auto (c): {after / 2 ** 20:.1f} MiB allocated "
                             f"after the search, {before / 2 ** 20:.1f} MiB "
                             f"before")
    return out, launches


def phase_auto(smi: str, llama1b: dict, reference_steps: int) -> dict:
    """auto_accelerate on the card: (a) a strategy's lowering trains the
    llama1b phase's bits (for ``reference_steps``, the observe phase's
    reference), (b) the default strategy fed by a coworker through the
    ring and the service, (c) the search; (d) each part's launches as
    predicted (see the module docstring)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    out = {"card": smi}
    parts = {}
    out["a"], parts["a"] = _auto_lowering(smi, llama1b, reference_steps)
    out["b"], parts["b"] = _auto_coworker(smi, repo)
    out["c"], parts["c"] = _auto_search(smi)
    for part in ("a", "b", "c"):
        if out[part]["launches"] != out[part]["want_launches"]:
            raise AssertionError(f"auto ({part}) launches "
                                 f"{out[part]['launches']}, want "
                                 f"{out[part]['want_launches']}")
    out["launches"] = _sum_counts(*parts.values())
    out["phase_s"] = time.monotonic() - t0
    log(f"auto: launches {json.dumps(out['launches'])}, phase "
        f"{out['phase_s']:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# resume: flash checkpoint and restore at Llama-1B
# ---------------------------------------------------------------------------

# the SIGTERM drill's worker: Llama-1B at 2 layers and full width, run
# through the port only, with the loop's SIGTERM handler installed. Both
# runs are spawned when the resume phase starts: each imports and builds
# its loop, then waits for its gate file, so their start-up overlaps legs
# A-C. The first run prints "ready" after its second step and pauses
# there, so the signal lands before its third step; the second run
# resumes.
SIGTERM_WORKER = r'''
import dataclasses, functools, json, sys, time
import torch
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

ckpt, first, gate = sys.argv[1], sys.argv[2] == "first", sys.argv[3]
cfg = dataclasses.replace(LlamaConfig.llama_1b(
    max_seq_len=2048, attn_impl="flash", norm_impl="fused",
    embed_impl="gather"), num_layers=2)
loop = ElasticTrainLoop(
    functools.partial(Llama, cfg),
    lambda p: torch.optim.AdamW(p, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.1),
    cross_entropy_loss,
    TrainLoopConfig(global_batch=8, seq_len=2048, max_micro_per_replica=8,
                    max_steps=8 if first else 2, checkpoint_dir=ckpt,
                    save_interval_steps=1000, report_interval_steps=0))
loop.install_signal_handler()
import os
while not os.path.exists(gate):
    time.sleep(0.05)
sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
state, start = loop.restore_or_init(0, sampler)
position = sampler.completed_num

def data():
    for i, batch in enumerate(batches(synthetic_corpus(cfg.vocab_size),
                                      sampler, 8, 2048)):
        if first and i == 2:
            print("ready", flush=True)
            # the parent signals as it reads the line: milliseconds
            time.sleep(1)
        yield batch

state, metrics = loop.run(state, data(), start_step=start, sampler=sampler)
print(json.dumps({"start": start, "position": position,
                  "step": metrics["step"],
                  "latest": loop.checkpointer.latest_step(),
                  "losses": [r["loss"] for r in metrics["history"]]}))
loop.close()
'''


def _free_memory() -> None:
    """Collect, and hand the card's and the host's cached blocks back
    (pinned host blocks too: the next loop pins its buffers anew)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, files in os.walk(path) for name in files)


def host_memory() -> dict:
    """This host's MemTotal and MemAvailable and /dev/shm's free bytes."""
    import shutil

    info = {"shm_free": 0}
    with open("/proc/meminfo") as f:
        for line in f:
            name, value = line.split(":", 1)
            if name in ("MemTotal", "MemAvailable"):
                info[name] = int(value.split()[0]) * 1024
    try:
        info["shm_free"] = shutil.disk_usage("/dev/shm").free
    except OSError:
        pass
    return info


def peer_root(state_bytes: int, tmp: str, smi: str, what: str) -> str:
    """A new directory for a peer cache (or an agent's work directory):
    on /dev/shm when it and the host's memory hold two stages beside the
    pinned host copy and one restore, else under ``tmp`` on disk. Fails,
    with the numbers, when the host cannot hold the pinned copy plus one
    restore."""
    import tempfile

    mem = host_memory()
    copies = 2 * state_bytes          # the pinned host copy + one restore
    on_shm = min(mem["shm_free"],
                 mem["MemAvailable"] - copies) >= 2 * state_bytes
    where = "/dev/shm" if on_shm else f"{tmp} (disk)"
    log(f"{what}: host MemTotal {mem['MemTotal'] / 1e9:.2f} GB, "
        f"MemAvailable {mem['MemAvailable'] / 1e9:.2f} GB, /dev/shm free "
        f"{mem['shm_free'] / 1e9:.2f} GB; pinned copy + one restore "
        f"{copies / 1e9:.2f} GB, two staged steps "
        f"{2 * state_bytes / 1e9:.2f} GB; the peer cache goes to {where} "
        f"({smi})")
    if mem["MemAvailable"] < copies:
        raise AssertionError(
            f"{mem['MemAvailable'] / 1e9:.2f} GB of host memory available: "
            f"less than the pinned host copy plus one restore "
            f"({copies / 1e9:.2f} GB)")
    return tempfile.mkdtemp(prefix="chip_smoke_peer_",
                            dir="/dev/shm" if on_shm else tmp)


def _resume_loop(cfg, ckpt_dir: str, bits: int, save_interval: int):
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    return ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                        max_micro_per_replica=8, max_steps=3,
                        checkpoint_dir=ckpt_dir,
                        save_interval_steps=save_interval,
                        checkpoint_quantize_bits=bits,
                        report_interval_steps=0))


def _sampler_and_data(cfg):
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)

    def data():
        # created at the first step, so a restored position counts
        yield from batches(synthetic_corpus(cfg.vocab_size), sampler, 8,
                           cfg.max_seq_len)

    return sampler, data()


def _saved_codes(ckpt_dir: str, step: int, state) -> dict:
    """The int8 codes and scales of a step on disk, read into host
    buffers laid out for ``state``'s parameters."""
    import os

    import torch.distributed.checkpoint as dcp

    from dlrover_tpu_torch.checkpoint import quantized as cq

    params = {n: p.detach() for n, p in state.model.named_parameters()}
    target = cq.abstract_encoded(params, 8)
    dcp.load({"model": target}, checkpoint_id=os.path.join(ckpt_dir,
                                                           str(step)))
    return target


def _check_saved_codes(ckpt_dir: str, step: int, state) -> None:
    """Before a restore: the codes on disk are the plain quantization of
    the parameters that were saved (``state`` at the saved step)."""
    from dlrover_tpu_torch.checkpoint import quantized as cq

    codes = _saved_codes(ckpt_dir, step, state)
    want = cq.encode_tree({n: p.detach().cpu() for n, p in
                           state.model.named_parameters()}, 8)
    bad = [name for name, node in codes.items() if cq._is_encoded(node)
           and not (torch.equal(node["q"], want[name]["q"])
                    and torch.equal(node["s"], want[name]["s"]))]
    if bad:
        raise AssertionError(f"saved codes differ from the plain "
                             f"quantization: {bad}")


def _check_restored_codes(ckpt_dir: str, step: int, state) -> int:
    """After a restore: the parameters (dequantized by the kernel) are
    the plain dequantization of the codes on disk, bit for bit; returns
    the leaves compared."""
    from dlrover_tpu_torch.checkpoint import quantized as cq
    from dlrover_tpu_torch.ops import quantization as qz

    codes = _saved_codes(ckpt_dir, step, state)
    params = dict(state.model.named_parameters())
    bad = []
    for name, node in codes.items():
        if not cq._is_encoded(node):
            continue
        got = params[name].detach().cpu()
        want = qz.dequantize_plain(node["q"].reshape(-1, 128),
                                   node["s"].reshape(-1, 1)
                                   ).reshape(got.shape)
        if not torch.equal(got, want):
            bad.append(name)
    if bad:
        raise AssertionError(f"restored parameters differ from the plain "
                             f"dequantization: {bad}")
    return len(codes)


def _quant_kernel_times() -> dict:
    """quantize_rows / dequantize_rows at the embed table's shape
    (32000×2048 f32, groups of 128), against their bounds."""
    from dlrover_tpu_torch.ops import quantization as qz

    g = torch.Generator(device="cuda").manual_seed(11)
    x2 = (0.02 * torch.randn(32000, 2048, generator=g, device="cuda")
          ).reshape(-1, 128)
    q2, s2 = qz.quantize_rows(x2, 127)
    n = x2.numel()
    out = {}
    for name, fn, bounds in (
            ("quantize", lambda: qz.quantize_rows(x2, 127),
             roofline(4 * n, PEAK_F32_FLOPS, 4 * n + n + 4 * len(x2))),
            ("dequantize", lambda: qz.dequantize_rows(q2, s2),
             roofline(n, PEAK_F32_FLOPS, n + 4 * len(x2) + 4 * n))):
        ms = time_ms(fn)
        out[name] = {"ms": ms, "bound_ms": bounds[0], "bound_by": bounds[1]}
    del x2, q2, s2
    return out


def _sigterm_workers(tmp: str) -> list:
    """D's two worker processes, spawned at once; each builds its loop
    and waits for its gate file (``_sigterm_drill`` opens them in turn).
    Returns [(mode, process, gate)]."""
    import os

    script = os.path.join(tmp, "sigterm_worker.py")
    with open(script, "w") as f:
        f.write(SIGTERM_WORKER)
    ckpt = os.path.join(tmp, "sigterm")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    workers = []
    for mode in ("first", "second"):
        gate = os.path.join(tmp, f"sigterm_{mode}.go")
        workers.append((mode, subprocess.Popen(
            [sys.executable, script, ckpt, mode, gate],
            stdout=subprocess.PIPE, text=True, env=env), gate))
    return workers


def _sigterm_drill(workers: list) -> dict:
    """D: a worker process gets SIGTERM after its second step, saves the
    step it stops on and exits 0; a second worker resumes there (the
    processes of ``_sigterm_workers``, opened in turn)."""
    outs = []
    try:
        for mode, proc, gate in workers:
            open(gate, "w").close()
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.strip() == "ready":
                    proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=300)
            if code != 0:
                raise AssertionError(f"SIGTERM drill {mode} run exited "
                                     f"{code}")
            outs.append(json.loads(lines[-1]))
    finally:
        for _, proc, _ in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    first, second = outs
    log(f"resume D (SIGTERM): first run stopped at step {first['step']} "
        f"(latest saved {first['latest']}), second started at "
        f"{second['start']} with the sampler at {second['position']}, "
        f"losses {first['losses']} then {second['losses']}")
    if not (first["step"] == first["latest"] == second["start"] == 3
            and second["position"] == 24):
        raise AssertionError(f"SIGTERM drill did not resume where it "
                             f"stopped: {first} {second}")
    return {"stopped_at": first["step"], "resumed_at": second["start"]}


def phase_resume(smi: str) -> dict:
    """Llama-1B at full width and depth through ElasticTrainLoop with a
    flash checkpoint: A 7 steps saving at 3 (staged into a peer cache) and
    once more after 7; B a fresh loop restores 3 from disk and trains 4-6,
    the same bits as A; F the same from the peer cache; C the same as B
    with int8 parameters (losses within 0.1%, 201 quantize and 201
    dequantize launches, codes bit for bit with the plain versions); D the
    SIGTERM drill; E 3 steps with the moments offloaded, the same bits as
    A's first 3."""
    import shutil
    import tempfile

    import os

    from dlrover_tpu_torch.checkpoint import quantized as cq
    from dlrover_tpu_torch.checkpoint.peer_restore import load_manifest
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = ckpt_config()
    params = cfg.param_count()
    state_bytes = 3 * 4 * params
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    out = {"card": smi}
    peer_dir = ""
    # D's workers start now and wait at their gates: their start-up runs
    # beside A-C
    sigterm = _sigterm_workers(tmp)
    try:
        free = shutil.disk_usage(tmp).free
        log(f"resume: checkpoints in {tmp}, {free / 1e9:.1f} GB free; one "
            f"exact checkpoint is {state_bytes / 1e9:.2f} GB ({smi})")
        if free < 1.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than one checkpoint")
        dir_a = f"{tmp}/exact"
        peer_dir = peer_root(state_bytes, tmp, smi, "resume")
        cache = f"{peer_dir}/cache"

        # A: 7 steps, the save at step 3 staged into the peer cache, then a
        # steady-state save after step 7 (its buffers already pinned;
        # straight through the checkpointer, not staged, and dropped
        # before B reads the newest step)
        os.environ[NodeEnv.PEER_CACHE_DIR] = cache
        loop = _resume_loop(cfg, dir_a, 0, 3)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        state, _ = loop.restore_or_init(0, sampler)
        state, m1 = loop.run(state, data, 0, sampler)
        first_save = dict(loop.checkpointer.last_save)
        loop.checkpointer.save_interval_steps = 0
        loop.config.max_steps = 4
        state, m2 = loop.run(state, data, 3, sampler)
        loop.checkpointer.maybe_save(7, state, force=True)
        loop.checkpointer.wait()
        steady_save = dict(loop.checkpointer.last_save)
        hist_a = m1["history"] + m2["history"]
        peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
        pinned_gb = loop.checkpointer.host.nbytes / 1e9
        pinning_s = first_save["host_alloc_s"]
        loop.close()
        del state, loop
        del os.environ[NodeEnv.PEER_CACHE_DIR]
        shutil.rmtree(f"{dir_a}/7")
        _free_memory()
        step_s = statistics.mean(r["step_time_s"] for r in hist_a)
        ckpt_bytes = _dir_bytes(f"{dir_a}/3")
        write_s = first_save["commit_s"] - first_save["blocking_s"]
        staged = load_manifest(cache)
        out["a"] = {"losses": [r["loss"] for r in hist_a],
                    "grad_norms": [r["grad_norm"] for r in hist_a],
                    "blocking_save_ms": first_save["blocking_s"] * 1e3,
                    "steady_blocking_save_ms":
                        steady_save["blocking_s"] * 1e3,
                    "blocking_share_of_step":
                        steady_save["blocking_s"] / step_s,
                    "first_save": first_save, "steady_save": steady_save,
                    "pinned_gb": pinned_gb, "pinning_s": pinning_s,
                    "commit_s": first_save["commit_s"], "bytes": ckpt_bytes,
                    "write_gb_s": ckpt_bytes / write_s / 1e9,
                    "staged_step": staged["step"],
                    "staged_bytes": sum(m["nbytes"] for m in
                                        staged["shards"].values()),
                    "steps_ms": [r["step_time_s"] * 1e3 for r in hist_a],
                    "peak_gb": peak_a,
                    "note": "run() waits for the commit at its end, "
                            "so steps 4-7 ran under step 3's peer-cache "
                            "write only"}
        log(f"resume A: {json.dumps(out['a'])} ({smi})")
        log(f"resume A blocking save by piece, first and steady state, s: "
            f"{json.dumps(first_save)} | {json.dumps(steady_save)}; the "
            f"host buffers' page-locking (once, inside the first save): "
            f"{pinned_gb:.2f} GB in {pinning_s:.3f} s; the first save "
            f"without it {first_save['blocking_s'] - pinning_s:.3f} s "
            f"({smi})")
        if staged["step"] != 3:
            raise AssertionError(f"A staged step {staged['step']}, not 3")

        # B: a fresh loop restores step 3 from disk and trains 4-6
        loop = _resume_loop(cfg, dir_a, 0, 0)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state, start = loop.restore_or_init(0, sampler)
        restore_peak = torch.cuda.max_memory_allocated() - before
        largest = max(p.numel() * 4 for p in state.model.parameters())
        timings = dict(loop.last_restore_timings)
        source = loop.last_restore_source
        position = sampler.completed_num
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        _free_memory()
        hist_b = m["history"]
        pairs = [(a[k], b[k]) for a, b in zip(hist_a[3:], hist_b)
                 for k in ("loss", "grad_norm")]
        same_bits = all(a == b for a, b in pairs)
        rel = max(abs(a - b) / abs(a) for a, b in pairs)
        out["b"] = {"start": start, "source": source, "sampler": position,
                    "losses": [r["loss"] for r in hist_b],
                    "same_bits": same_bits, "max_rel_diff": rel,
                    "restore_peak_gb": restore_peak / 2 ** 30,
                    "limit_gb": (state_bytes + largest) / 2 ** 30,
                    "read_gb_s": timings.get("restore_restored_bytes", 0)
                    / max(timings.get("restore_tensor_read_s", 0), 1e-9)
                    / 1e9, "timings": timings}
        log(f"resume B: {json.dumps(out['b'])} ({smi})")
        if (start, source, position, len(hist_b)) != (3, "checkpoint", 24,
                                                      3):
            raise AssertionError(f"B resumed at step {start} from {source},"
                                 f" sampler {position}, ran {len(hist_b)} "
                                 f"steps")
        if not (same_bits or rel < 1e-6):
            raise AssertionError(f"B's steps 4-6 differ from A's by {rel}")
        if restore_peak > state_bytes + largest:
            raise AssertionError(f"restore peaked at {restore_peak} bytes, "
                                 f"over the state's {state_bytes} + "
                                 f"{largest}")

        # F: a fresh loop with A's peer cache and no master restores step 3
        # through the local pseudo-plan and trains 4-6
        os.environ[NodeEnv.PEER_CACHE_DIR] = cache
        loop = _resume_loop(cfg, dir_a, 0, 0)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state, start = loop.restore_or_init(0, sampler)
        peak_f = torch.cuda.max_memory_allocated() - before
        timings_f = dict(loop.last_restore_timings)
        source = loop.last_restore_source
        position = sampler.completed_num
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        del os.environ[NodeEnv.PEER_CACHE_DIR]
        _free_memory()
        hist_f = m["history"]
        same_f = [(a["loss"], a["grad_norm"]) == (f["loss"], f["grad_norm"])
                  for a, f in zip(hist_a[3:], hist_f)]
        out["f"] = {"start": start, "source": source, "sampler": position,
                    "losses": [r["loss"] for r in hist_f],
                    "same_bits": same_f, "restore_peak_gb": peak_f / 2 ** 30,
                    "limit_gb": (state_bytes + largest) / 2 ** 30,
                    "timings": timings_f}
        parts = {
            "peer": {k: timings_f.get(k) for k in (
                "peer_plan_s", "peer_transfer_s", "peer_assemble_s",
                "peer_restore_s", "peer_bytes", "peer_bandwidth_mbps")},
            "checkpoint (B)": {k: timings.get(k) for k in (
                "dcp_read_s", "restore_tensor_read_s",
                "restore_restored_bytes", "restore_read_bandwidth_mbps")}}
        out["f"]["parts_beside_b"] = parts
        log(f"resume F: {json.dumps(out['f'])} ({smi})")
        log(f"resume F restore by part beside B's read: {json.dumps(parts)} "
            f"({smi})")
        if (start, source, position, len(hist_f)) != (3, "peer", 24, 3):
            raise AssertionError(f"F resumed at step {start} from {source}, "
                                 f"sampler {position}, ran {len(hist_f)} "
                                 f"steps")
        if not all(same_f):
            raise AssertionError(f"F's steps 4-6 differ from A's: {same_f}")
        if peak_f > state_bytes + largest:
            raise AssertionError(f"peer restore peaked at {peak_f} bytes, "
                                 f"over the state's {state_bytes} + "
                                 f"{largest}")
        shutil.rmtree(peer_dir)
        shutil.rmtree(dir_a)

        # C: int8 parameters
        dir_c = f"{tmp}/int8"
        loop = _resume_loop(cfg, dir_c, 8, 3)
        sampler, data = _sampler_and_data(cfg)
        state, _ = loop.restore_or_init(0, sampler)
        reset_counts()
        state, _ = loop.run(state, data, 0, sampler)
        save_launches = read_counts()
        save_c = dict(loop.checkpointer.last_save)
        _check_saved_codes(dir_c, 3, state)
        params_sd = {n: p.detach() for n, p in state.model.named_parameters()}
        enc = cq.abstract_encoded(params_sd, 8)
        codes = sum(n["q"].numel() for n in enc.values() if cq._is_encoded(n))
        scales = sum(n["s"].numel() * 4 for n in enc.values()
                     if cq._is_encoded(n))
        loop.close()
        del state, loop, params_sd, enc
        _free_memory()
        loop = _resume_loop(cfg, dir_c, 8, 0)
        sampler, data = _sampler_and_data(cfg)
        reset_counts()
        state, start = loop.restore_or_init(0, sampler)
        restore_launches = read_counts()
        leaves = _check_restored_codes(dir_c, start, state)
        timings_c = dict(loop.last_restore_timings)
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        _free_memory()
        hist_c = m["history"]
        rel_c = max(abs(a["loss"] - c["loss"]) / a["loss"]
                    for a, c in zip(hist_a[3:], hist_c))
        out["c"] = {"start": start, "losses": [r["loss"] for r in hist_c],
                    "max_rel_loss_diff": rel_c,
                    "quantize_launches": save_launches["quantize"],
                    "dequantize_launches": restore_launches["dequantize"],
                    "leaves": leaves, "bytes": _dir_bytes(f"{dir_c}/3"),
                    "codes_bytes": codes, "scales_bytes": scales,
                    "timings": timings_c, "save": save_c,
                    "kernels_at_embed": _quant_kernel_times()}
        log(f"resume C: {json.dumps(out['c'])} ({smi})")
        if start != 3 or len(hist_c) != 3 or not rel_c < 1e-3:
            raise AssertionError(f"C: start {start}, losses off by {rel_c}")
        # one quantize a parameter saving, one dequantize restoring
        leaves_n = len(list(Llama(cfg, device="meta").parameters()))
        if (save_launches["quantize"], restore_launches["dequantize"]) != (
                leaves_n, leaves_n):
            raise AssertionError(f"C launched {save_launches} saving and "
                                 f"{restore_launches} restoring")
        shutil.rmtree(dir_c)

        out["d"] = _sigterm_drill(sigterm)

        # E: the first 3 steps again, moments in host memory between steps
        trainer = build_trainer(functools.partial(Llama, cfg), _adamw, None,
                                torch.zeros(8, cfg.max_seq_len),
                                cross_entropy_loss, micro_batch=8,
                                offload_opt_state=True)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init(0)
        hist_e = []
        for _, (tokens, targets) in zip(range(3), data):
            t0 = time.monotonic()
            state, metrics = trainer.step(state, *trainer.shard_batch(
                tokens, targets))
            hist_e.append((float(metrics["loss"]), time.monotonic() - t0))
            sampler.record_batch(8)
        moments = [v for s in state.optimizer.state.values()
                   for v in s.values() if v.ndim > 0]
        pinned = all(v.device.type == "cpu" and v.is_pinned()
                     for v in moments)
        peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, trainer, moments
        _free_memory()
        out["e"] = {"losses": [x for x, _ in hist_e],
                    "step_ms": [t * 1e3 for _, t in hist_e],
                    "peak_gb": peak_e, "pinned_between_steps": pinned,
                    "a_step_median_ms": _bare_loop_median_ms(out),
                    "a_peak_gb": peak_a}
        log(f"resume E (offload): {json.dumps(out['e'])} ({smi})")
        if out["e"]["losses"] != out["a"]["losses"][:3] or not pinned:
            raise AssertionError(f"offloaded steps {out['e']['losses']} "
                                 f"against {out['a']['losses'][:3]}, pinned "
                                 f"{pinned}")
    finally:
        for _, proc, _ in sigterm:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        # the peer cache may lie on /dev/shm, outside ``tmp``
        if peer_dir:
            shutil.rmtree(peer_dir, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# standalone: the control plane (master, agent, worker) around Llama-1B
# ---------------------------------------------------------------------------

# the master's tokens/s against the worker's own over the same steps
SPEED_TOL = 0.05
# the worker under the agent: steps, saving every SAVE_EVERY (the kill
# comes once the first save is committed; a relaunch resumes at 3 or 6)
STANDALONE_STEPS = 7
SAVE_EVERY = 3


def _reference_run(cfg, steps: int = STANDALONE_STEPS) -> list:
    """Resume's run A without its checkpoint: ``steps`` uninterrupted
    steps from the same seed and data, [(loss, grad_norm)] a step."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                        max_micro_per_replica=8, max_steps=steps,
                        report_interval_steps=0))
    sampler, data = _sampler_and_data(cfg)
    state, _ = loop.restore_or_init(0, sampler)
    state, metrics = loop.run(state, data, 0, sampler)
    loop.close()
    del state, loop
    _free_memory()
    return [(r["loss"], r["grad_norm"]) for r in metrics["history"]]


def _children(pid: int) -> list:
    """The processes whose parent is ``pid``, from /proc."""
    import os

    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command may hold spaces: the fields after it start past ')'
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(name))
    return kids


def _agent_times(path: str) -> dict:
    """Wall-clock marks of the agent's relaunch, and the rendezvous round
    of each spawn, from its log lines ("[2026-10-17 00:58:52,261]
    [WARNING] [...] message")."""
    import datetime
    import re

    marks = {"rounds": []}
    patterns = {"detected": r"worker failed \(exit -9, killed\); backing",
                "backed_off": r"worker failed \(exit -9, killed\); restart",
                "spawned": r"spawning worker \(round 1,"}
    with open(path) as f:
        for line in f:
            m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\]", line)
            if not m:
                continue
            ts = datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            for key, pattern in patterns.items():
                if key not in marks and re.search(pattern, line):
                    marks[key] = ts
            spawn = re.search(r"spawning worker \(round (\d+),", line)
            if spawn:
                marks["rounds"].append(int(spawn.group(1)))
    return marks


# the worker's log lines that mark a fault's timeline: first line
# starting with each prefix → its name in a run's "marks"
_WORKER_MARKS = {
    "chaos: preemption notice": "notice",
    "drain request at step": "drain_request_consumed",
    "emergency checkpoint": "emergency",
    "drained at step": "drained",
    "chaos: hanging": "hang_start",
    "step-hang watchdog": "watchdog_fired",
    "llama_train: done": "done",
}


def _worker_log(path: str) -> list:
    """The worker's incarnations from its log file: for each, its start
    step, restore source and timings, steps {step: (time, loss,
    grad_norm, step_s)}, saves {step: (time, blocking pieces)}, commits
    and peer-cache writes {step: end time}, the boundary collections
    {step: seconds}, launch counts and wall-clock marks."""
    import re

    runs = []
    with open(path) as f:
        for line in f:
            ts, _, text = line.rstrip("\n").partition(" ")
            if text.startswith("llama_train: start_step="):
                start = int(re.search(r"start_step=(\d+)", text).group(1))
                source = re.search(r"source=(\S+)", text).group(1)
                restore = json.loads(text.split("restore=", 1)[1])
                pid = re.search(r" pid=(\d+)", text)
                runs.append({"start": start, "source": source,
                             "pid": int(pid.group(1)) if pid else None,
                             "restore": restore, "steps": {}, "saves": {},
                             "commits": {}, "peer_writes": {}, "marks": {},
                             "collections": {}, "started_at": float(ts)})
                continue
            if not runs:
                continue
            run = runs[-1]
            m = re.match(r"step (\d+) loss (\S+) grad_norm (\S+) step_s "
                         r"(\S+)", text)
            save = re.search(r"async save started at step (\d+), blocking "
                             r"\S+ s: (\{.*\})$", text)
            done = (re.search(r"flash checkpoint: step (\d+) committed", text)
                    or re.search(r"peer cache: step (\d+) staged", text))
            collected = re.match(r"collection after step (\d+): (\S+) s",
                                 text)
            if m:
                run["steps"][int(m.group(1))] = (
                    float(ts), float(m.group(2)), float(m.group(3)),
                    float(m.group(4)))
            elif save:
                run["saves"][int(save.group(1))] = (float(ts), json.loads(
                    save.group(2)))
            elif done:
                kind = "commits" if "committed" in text else "peer_writes"
                run[kind][int(done.group(1))] = float(ts)
            elif collected:
                run["collections"][int(collected.group(1))] = float(
                    collected.group(2))
            elif text.startswith("worker_launch_counts "):
                # the last line holds the launches so far (one a step)
                run["launches"] = json.loads(text.split(" ", 1)[1])
            elif any(text.startswith(mark) for mark in _WORKER_MARKS):
                mark = next(m for m in _WORKER_MARKS if text.startswith(m))
                run["marks"].setdefault(_WORKER_MARKS[mark],
                                        (float(ts), text))
            elif text.startswith("worker_times "):
                run["times"] = json.loads(text.split(" ", 1)[1])
    for run in runs:
        run["runs_under_writers"] = _under_writers(run)
    return runs


def _under_writers(run: dict) -> dict:
    """Each step that ended while a save's commit or peer-cache write
    (started at an earlier step) was still running: {step: (step_ms,
    "commit", "peer")} with the writers it overlapped."""
    out = {}
    for n, (t, *_, step_s) in sorted(run["steps"].items()):
        writers = []
        for saved, (t_save, _) in run["saves"].items():
            if saved >= n:
                continue
            for kind in ("commits", "peer_writes"):
                end = run[kind].get(saved, float("inf"))
                if t_save < t <= end:
                    writers.append(f"{kind[:-1]} of {saved}")
        if writers:
            out[n] = (step_s * 1e3, writers)
    return out


def _killed_state(ckpt: str, agent_tmp: str) -> tuple:
    """The newest committed step under ``ckpt`` and the step of the last
    complete peer stage in the agent's work directory under
    ``agent_tmp`` (its manifest is written last), -1 when none."""
    import glob
    import os

    from dlrover_tpu_torch.checkpoint.peer_restore import load_manifest

    names = os.listdir(ckpt) if os.path.isdir(ckpt) else []
    committed = max((int(n) for n in names if n.isdigit()), default=-1)
    caches = glob.glob(os.path.join(agent_tmp, "dlrover-tpu-agent-*",
                                    "peer_cache"))
    manifest = load_manifest(caches[0]) if len(caches) == 1 else None
    return committed, (manifest or {}).get("step", -1)


def _kill_ready(ckpt: str, agent_tmp: str, first_save: int) -> bool:
    """Whether the worker may be killed: a step at or past ``first_save``
    is committed and a complete peer stage at least as new is there.
    DCP's commit and the peer-cache write of one save run side by side,
    so waiting for both keeps the relaunch's source from hanging on
    which finished first."""
    committed, staged = _killed_state(ckpt, agent_tmp)
    return committed >= first_save and staged >= committed


def _wait_dead(pid: int, timeout_s: float = 60.0) -> None:
    """Until ``pid`` has exited (gone, or a zombie not reaped yet)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return
        except OSError:
            return
        time.sleep(0.01)
    raise AssertionError(f"process {pid} still alive {timeout_s} s after "
                         f"SIGKILL")


def phase_standalone(smi: str, resume: dict) -> dict:
    """Llama-1B under the port's master and agent, with a SIGKILL after
    the first committed checkpoint (see the module docstring)."""
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster

    cfg = ckpt_config()
    ref, ref_from = _reference_steps(cfg, resume)
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_standalone_")
    ckpt, worker_log = f"{tmp}/ckpt", f"{tmp}/worker.log"
    agent_out, agent_err = f"{tmp}/agent.out", f"{tmp}/agent.err"
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    proc, agent_tmp = None, ""
    out = {"card": smi}
    _free_memory()
    log(f"standalone: this process holds "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"standalone: checkpoints in {tmp}, {free / 1e9:.1f} GB free; "
            f"the run keeps at most two of {state_bytes / 1e9:.2f} GB")
        if free < 2.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than two checkpoints")
        # the agent's work directory (its peer cache) lands in TMPDIR
        agent_tmp = peer_root(state_bytes, tmp, smi, "standalone")
        out["host_memory"] = host_memory()
        out["agent_tmp"] = agent_tmp
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run",
               "--master-addr", master.addr,
               "dlrover_tpu_torch/examples/llama_train.py",
               "--config", "llama_1b", "--layers", str(CKPT_LAYERS),
               "--steps", str(STANDALONE_STEPS),
               "--save-interval", str(SAVE_EVERY), "--report-interval", "1",
               "--ckpt-dir", ckpt, "--log-file", worker_log]
        env = dict(os.environ, PYTHONPATH=repo, TMPDIR=agent_tmp)
        with open(agent_out, "w") as fo, open(agent_err, "w") as fe:
            proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=fo,
                                    stderr=fe)
        # SIGKILL the worker (the agent's child) once step 3 is committed
        # and staged
        deadline = time.time() + STANDALONE_WAIT_S
        victim = None
        while time.time() < deadline and proc.poll() is None:
            if _kill_ready(ckpt, agent_tmp, SAVE_EVERY):
                kids = _children(proc.pid)
                if kids:
                    victim = kids[0]
                    break
            time.sleep(0.05)
        if victim is None:
            raise AssertionError(f"no committed and staged step 3 or no "
                                 f"worker (agent exit {proc.poll()}, "
                                 f"{_killed_state(ckpt, agent_tmp)})")
        os.kill(victim, signal.SIGKILL)
        t_kill = time.time()
        _wait_dead(victim)
        # what the dead worker left, read now that nothing can change it:
        # the relaunch must resume at the newer of the two
        committed, staged = _killed_state(ckpt, agent_tmp)
        resume_at = max(committed, staged)
        out["at_kill"] = {"committed": committed, "staged": staged,
                          "resume_at": resume_at}
        # the master's speed over the first incarnation's step reports: a
        # report already on the wire lands within the second, the new
        # incarnation's first one tens of seconds later. (Its resumed
        # reports at or below this mark are dropped, as in the JAX
        # master.)
        time.sleep(max(0.0, t_kill + 1.0 - time.time()))
        killed_at = (master.speed_monitor.completed_global_step,
                     master.speed_monitor.tokens_per_second(),
                     master.speed_monitor.running_mfu())
        code = proc.wait(timeout=STANDALONE_WAIT_S)
        with open(agent_err) as f:
            agent_tail = f.read()[-3000:]
        if code != 0:
            raise AssertionError(f"agent exited {code}: {agent_tail}")
        runs = _worker_log(worker_log)
        marks = _agent_times(agent_err)
        out["worker_pid_killed"] = victim
        if len(runs) != 2:
            raise AssertionError(f"{len(runs)} worker incarnations logged")
        first, second = runs
        got = {n: (r[1], r[2]) for run in runs
               for n, r in run["steps"].items()
               if run is second or n <= resume_at}
        same = {n: got.get(n) == ref[n - 1]
                for n in range(1, STANDALONE_STEPS + 1)}
        out.update({
            "reference": ref_from,
            "first_start": first["start"], "second_start": second["start"],
            "second_source": second["source"],
            "first_steps": sorted(first["steps"]),
            "losses": [got.get(n, (None,))[0]
                       for n in range(1, STANDALONE_STEPS + 1)],
            "same_bits": same, "spawn_rounds": marks["rounds"],
            "master_rounds_cut": master.rdzv_managers[
                RendezvousName.TRAINING].rdzv_round})
        log(f"standalone: {json.dumps(out)} ({smi})")
        if first["start"] != 0 or second["start"] != resume_at:
            raise AssertionError(f"incarnations started at {first['start']}"
                                 f" and {second['start']}, the kill left "
                                 f"{out['at_kill']}")
        if second["source"] != "peer":
            raise AssertionError(f"the relaunched worker restored from "
                                 f"{second['source']}, not the peer cache")
        resumed = list(range(resume_at + 1, STANDALONE_STEPS + 1))
        if sorted(second["steps"]) != resumed or not all(same.values()):
            raise AssertionError(f"steps against {ref_from}: {same}")
        if marks["rounds"] != [0, 1] or out["master_rounds_cut"] != 2:
            raise AssertionError(f"spawned in rounds {marks['rounds']}, "
                                 f"{out['master_rounds_cut']} rounds cut: "
                                 f"{agent_tail}")

        # the master's view: the last step at the end; at the kill, the
        # tokens/s of the first incarnation's reports (steps 1 to the
        # mark, on the master's clock) against the worker's own log over
        # the same steps (the step lines, logged just before each report)
        tokens = 8 * cfg.max_seq_len
        steps = second["steps"]
        mark, master_tps, master_mfu = killed_at
        logged = first["steps"]
        if mark < 2 or mark not in logged or 1 not in logged:
            raise AssertionError(f"master mark {mark} at the kill, first "
                                 f"incarnation logged {sorted(logged)}")
        worker_tps = ((mark - 1) * tokens
                      / (logged[mark][0] - logged[1][0]))
        master_step = master.speed_monitor.completed_global_step
        out["master"] = {"global_step": master_step,
                         "mark_at_kill": mark,
                         "tokens_per_s_at_kill": master_tps,
                         "worker_tokens_per_s": worker_tps,
                         "rel_diff": abs(master_tps - worker_tps)
                         / worker_tps, "mfu_at_kill": master_mfu,
                         "tokens_per_s_at_end": master.speed_monitor
                         .tokens_per_second()}
        log(f"standalone master: {json.dumps(out['master'])} ({smi})")
        if (master_step != STANDALONE_STEPS
                or not out["master"]["rel_diff"] < SPEED_TOL):
            raise AssertionError(f"master holds {out['master']}")

        want = _expected_launches(cfg, len(resumed))
        launches = second.get("launches")
        out["launches"] = launches
        if launches != want:
            raise AssertionError(f"worker launches {launches}, want {want}")

        # recovery: SIGKILL → the new incarnation's first finished step,
        # and on to its second (back at the step's speed)
        times, restore = second["times"], second["restore"]
        t_first = steps[resumed[0]][0]
        if len(resumed) < 2:
            raise AssertionError(f"resumed steps {resumed}: no second step")
        parts = {
            "detection_s": marks["detected"] - t_kill,
            "backoff_s": marks["backed_off"] - marks["detected"],
            "rendezvous_s": marks["spawned"] - marks["backed_off"],
            "process_start_and_import_s": times["imported"]
            - marks["spawned"],
            "loop_build_s": times["loop_built"] - times["imported"],
            "restore_s": times["restored"] - times["loop_built"],
            "of_which_abstract_state_s": restore.get("abstract_state_s"),
            "of_which_peer_plan_s": restore.get("peer_plan_s"),
            "of_which_transfer_s": restore.get("peer_transfer_s"),
            "of_which_assemble_s": restore.get("peer_assemble_s"),
            "of_which_kernel_libraries_load_s": restore.get("build_s"),
            "peer_bytes": restore.get("peer_bytes"),
            "peer_bandwidth_mbps": restore.get("peer_bandwidth_mbps"),
            "first_step_s": steps[resumed[0]][3],
            "other_s": t_first - times["restored"] - steps[resumed[0]][3],
            "total_s": t_first - t_kill,
            "second_step_s": steps[resumed[1]][3],
            "total_to_second_step_s": steps[resumed[1]][0] - t_kill}
        out["recovery"] = parts
        log(f"standalone recovery (SIGKILL to step {resumed[0]} done): "
            f"{json.dumps(parts)} ({smi})")
        out["saves"] = {f"incarnation {i} step {n}": pieces
                        for i, run in enumerate(runs)
                        for n, (_, pieces) in run["saves"].items()}
        # each incarnation's first save page-locks its host buffers
        out["pinning_s"] = {
            f"incarnation {i} step {min(run['saves'])}":
                run["saves"][min(run["saves"])][1].get("host_alloc_s")
            for i, run in enumerate(runs) if run["saves"]}
        log(f"standalone blocking saves by piece, s: "
            f"{json.dumps(out['saves'])}; of which the host buffers' "
            f"page-locking, once a process inside its first save, s: "
            f"{json.dumps(out['pinning_s'])} ({smi})")
        out["under_writers"] = {f"incarnation {i}": run["runs_under_writers"]
                                for i, run in enumerate(runs)}
        log(f"standalone steps that ran under a commit or a peer-cache "
            f"write (ms, writers): {json.dumps(out['under_writers'])} "
            f"({smi})")
        under_agent = [r[3] for run in runs for n, r in run["steps"].items()
                       if n != run["start"] + 1]
        out["step_under_agent"] = {
            "median_ms": statistics.median(under_agent) * 1e3,
            "steps_ms": [t * 1e3 for t in under_agent],
            "bare_loop_median_ms": _bare_loop_median_ms(resume)}
        log(f"standalone step under the agent: "
            f"{json.dumps(out['step_under_agent'])} ({smi})")
        log(f"standalone host memory after the run: "
            f"{json.dumps(host_memory())} ({smi})")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        master.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# the faults phase: launch 1 drains at step DRAIN_AT under a stated grace
# (the emergency save waits for the step-3 commit and then commits its
# own: two commits of 16.5-26.1 s, chip runs of the resume phase), with
# a `slow` fault holding step DRAIN_AT for DRAIN_HOLD_S so the agent's
# drain request (notice poll 1 s, its loop 0.2 s) lands before the next
# step boundary; launch 2 hangs at step HANG_AT, after the step-6 save,
# for HANG_SLEEP_S under a watchdog of HANG_WATCHDOG_S (it fires 7-8.75 s
# after step 6, its poll being a quarter of it: past the peer stage of 6,
# 4-7.5 s at 8 layers and about 0.6 of that at CKPT_LAYERS = 4; the sleep
# outlasts it with 3 s to spare), and its relaunch replays the hang
# inside the watchdog's first-step budget of 300 s. Both were 12 s and
# 20 s at 8 layers: the hang runs twice by design, so they are cut with
# the depth
FAULT_GRACE_S = 90.0
DRAIN_AT = 4
DRAIN_HOLD_S = 3.0
HANG_AT = 7
HANG_WATCHDOG_S = 7.0
HANG_SLEEP_S = 12.0
DEFAULT_GRACE_S = 30.0     # Context.preempt_default_grace_s


def _bare_loop_median_ms(resume: dict):
    """The median step of resume's run A past its first (the same model
    in this process, no agent), or "not measured"."""
    if not resume.get("a"):
        return "not measured"
    return statistics.median(resume["a"]["steps_ms"][1:])


def _reference_steps(cfg, resume: dict) -> tuple:
    """[(loss, grad_norm)] of 7 uninterrupted steps and where they came
    from: resume's run A when it ran, else an in-process run (kept for a
    later phase)."""
    if resume.get("a"):
        return (list(zip(resume["a"]["losses"], resume["a"]["grad_norms"])),
                "resume A")
    if "run" not in _REFERENCE:
        _REFERENCE["run"] = _reference_run(cfg)
    return _REFERENCE["run"], "an uninterrupted in-process run"


_REFERENCE: dict = {}


def _reference_prefix(cfg, steps: int) -> list:
    """The first ``steps`` of the longest uninterrupted in-process run of
    ``cfg``'s depth so far (its steps do not depend on the run's length),
    running a longer one when none reaches ``steps``."""
    key = ("long", cfg.num_layers)
    if len(_REFERENCE.get(key, ())) < steps:
        _REFERENCE[key] = _reference_run(cfg, steps)
    return _REFERENCE[key][:steps]


def _agent_lines(path: str) -> list:
    """(unix time, message) of each of the agent's log lines
    ("[2026-10-17 00:58:52,261] [WARNING] [...] message")."""
    import datetime
    import re

    lines = []
    with open(path) as f:
        for line in f:
            m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\] "
                         r"\[\w+\] \[[^\]]*\] (.*)$", line.rstrip("\n"))
            if m:
                lines.append((datetime.datetime.strptime(
                    m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(),
                    m.group(2)))
    return lines


def _first(lines: list, pattern: str) -> float:
    import re

    for ts, text in lines:
        if re.search(pattern, text):
            return ts
    raise AssertionError(f"no agent line matches {pattern!r}")


def _spawn_agent(master, cmd_args: list, env_extra: dict, out: str,
                 err: str, agent_tmp: str, repo: str,
                 run_args: tuple = ()):
    """Start ``python -m dlrover_tpu_torch.run`` (with ``run_args``)
    against ``master`` with core dumps off (a SIGABRTed worker holding
    15 GB of page-locked memory must not write one); returns the Popen
    and its two open log files."""
    import os
    import resource

    cmd = ([sys.executable, "-m", "dlrover_tpu_torch.run",
            "--master-addr", master.addr] + list(run_args)
           + ["dlrover_tpu_torch/examples/llama_train.py"] + cmd_args)
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=agent_tmp, **env_extra)
    # the agent inherits this process's soft core limit (set here, not
    # in a preexec_fn: the master's gRPC threads make that unsafe)
    soft, hard = resource.getrlimit(resource.RLIMIT_CORE)
    fo, fe = open(out, "w"), open(err, "w")
    resource.setrlimit(resource.RLIMIT_CORE, (0, hard))
    try:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=fo,
                                stderr=fe)
    finally:
        resource.setrlimit(resource.RLIMIT_CORE, (soft, hard))
    return proc, (fo, fe)


def _launch_agent(master, cmd_args: list, env_extra: dict, out: str,
                  err: str, agent_tmp: str, repo: str,
                  run_args: tuple = ()) -> int:
    """Run ``python -m dlrover_tpu_torch.run`` (with ``run_args``) against
    ``master`` to its end (``_spawn_agent``); returns its exit code."""
    proc, files = _spawn_agent(master, cmd_args, env_extra, out, err,
                               agent_tmp, repo, run_args)
    try:
        return proc.wait(timeout=FAULTS_LAUNCH_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files:
            f.close()


def phase_faults(smi: str, resume: dict) -> dict:
    """Planned and silent failures under the port's master and agent:
    a preemption notice drained through an emergency checkpoint, then a
    hang the watchdog aborts and the agent relaunches uncharged; the
    master's goodput ledger accounts both (see the module docstring)."""
    import glob
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.obs import render_snapshot

    cfg = ckpt_config()
    ref, ref_from = _reference_steps(cfg, resume)
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    ckpt = f"{tmp}/ckpt"
    ctx = Context.singleton()
    # the master's ledger bounds a hang by the watchdog's window
    saved_hang_s = ctx.hang_watchdog_s
    ctx.update(hang_watchdog_s=HANG_WATCHDOG_S)
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = None
    agent_tmp = ""
    out = {"card": smi}
    _free_memory()
    try:
        free = shutil.disk_usage(tmp).free
        log(f"faults: checkpoints in {tmp}, {free / 1e9:.1f} GB free; the "
            f"run keeps at most three of {state_bytes / 1e9:.2f} GB")
        if free < 3.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than three checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "faults")
        common = ["--config", "llama_1b", "--layers", str(CKPT_LAYERS),
                  "--steps", str(STANDALONE_STEPS),
                  "--save-interval", str(SAVE_EVERY), "--report-interval",
                  "1", "--ckpt-dir", ckpt]

        # -- launch 1: a preemption notice at DRAIN_AT -------------------
        log1, err1 = f"{tmp}/worker1.log", f"{tmp}/agent1.err"
        code = _launch_agent(master, common + ["--log-file", log1], {
            "DLROVER_TPU_CHAOS": f"preempt:worker:0@{DRAIN_AT}:"
                                 f"{FAULT_GRACE_S};slow:worker:0@{DRAIN_AT}:"
                                 f"{DRAIN_HOLD_S}",
            "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos1",
            "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight1"},
            f"{tmp}/agent1.out", err1, agent_tmp, repo)
        lines1 = _agent_lines(err1)
        tail1 = "\n".join(t for _, t in lines1[-15:])
        if code != 0:
            raise AssertionError(f"launch 1: agent exited {code}: {tail1}")
        runs1 = _worker_log(log1)
        if len(runs1) != 1:
            raise AssertionError(f"launch 1: {len(runs1)} incarnations")
        a = runs1[0]
        marks = a["marks"]
        drained = [t for _, t in lines1 if t.startswith("drain complete")]
        charged = [t for _, t in lines1 if "worker failed" in t
                   or "restarting (" in t]
        if (not drained or "worker exit 76, drained" not in drained[0]
                or charged):
            raise AssertionError(f"launch 1: the worker did not leave "
                                 f"with 76 (drained) uncharged: {tail1}")
        drain_step = int(marks["drained"][1].split()[3])
        emergency = marks.get("emergency", (0, ""))[1]
        committed = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
        if (drain_step != DRAIN_AT
                or "(checkpoint: saved)" not in marks["drained"][1]
                or not emergency.startswith(
                    f"emergency checkpoint committed at step {drain_step}")
                or drain_step not in committed):
            raise AssertionError(f"launch 1: drained at {drain_step}, "
                                 f"{emergency!r}, committed {committed}")
        t_notice = marks["notice"][0]
        t_request = _first(lines1, r"^drain request \d+ written")
        t_consumed = marks["drain_request_consumed"][0]
        t_drained = marks["drained"][0]
        t_exit = _first(lines1, r"^drain complete")
        save = a["saves"][drain_step][1]
        drain = {
            "drained_step": drain_step, "committed": committed,
            "notice_to_request_s": t_request - t_notice,
            "request_to_consumed_s": t_consumed - t_request,
            "consumed_to_drained_s": t_drained - t_consumed,
            "drained_to_exit_seen_s": t_exit - t_drained,
            "notice_to_exit_s": t_exit - t_notice,
            "of_which_hold_s": DRAIN_HOLD_S,
            "emergency_blocking_s": save.get("blocking_s"),
            "emergency_wait_for_previous_commit_s": save.get("wait_s"),
            "emergency_page_locking_s": save.get("host_alloc_s"),
            "emergency_commit_s": a["commits"].get(drain_step, 0.0)
            - a["saves"][drain_step][0],
            "grace_s": FAULT_GRACE_S,
            "default_grace_would_hold": t_exit - t_notice < DEFAULT_GRACE_S,
            "pinning_first_save_s": a["saves"][min(a["saves"])][1].get(
                "host_alloc_s")}
        out["drain"] = drain
        log(f"faults drain (notice at step {DRAIN_AT}, grace "
            f"{FAULT_GRACE_S:.0f} s): {json.dumps(drain)} ({smi})")
        if not drain["notice_to_exit_s"] < FAULT_GRACE_S:
            raise AssertionError(f"notice to exit "
                                 f"{drain['notice_to_exit_s']:.1f} s, over "
                                 f"the grace")

        # -- launch 2: a hang at HANG_AT, after the step-6 save ----------
        log2, err2 = f"{tmp}/worker2.log", f"{tmp}/agent2.err"
        flight2 = f"{tmp}/flight2"
        code = _launch_agent(master, common + ["--log-file", log2], {
            "DLROVER_TPU_CHAOS": f"hang:worker:0@{HANG_AT}:{HANG_SLEEP_S}",
            "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos2",
            "DLROVER_TPU_HANG_WATCHDOG_S": str(HANG_WATCHDOG_S),
            "DLROVER_TPU_FLIGHT_DIR": flight2},
            f"{tmp}/agent2.out", err2, agent_tmp, repo)
        lines2 = _agent_lines(err2)
        tail2 = "\n".join(t for _, t in lines2[-15:])
        if code != 0:
            raise AssertionError(f"launch 2: agent exited {code}: {tail2}")
        runs2 = _worker_log(log2)
        failed = [t for _, t in lines2 if "worker failed" in t]
        restarts = [t for _, t in lines2 if "restarting (" in t]
        if (len(runs2) != 2 or len(failed) != 2
                or not all("(exit -6, hang)" in t for t in failed)
                or restarts != [restarts[0]]
                or "restarting (0/" not in restarts[0]):
            raise AssertionError(f"launch 2: {len(runs2)} incarnations, "
                                 f"want one uncharged hang abort: {tail2}")
        b, c = runs2
        # the watchdog's flight dump of the aborted worker: the main
        # thread's stack in the chaos sleep
        stacks = []
        for path in glob.glob(f"{flight2}/flight-*.json"):
            with open(path) as f:
                payload = json.load(f)
            stacks += [e["attrs"]["stacks"] for e in payload["events"]
                       if e.get("name") == "step_hang"]
        in_sleep = [st for st in stacks if any(
            "maybe_inject" in frame and "time.sleep" in frame
            for frame in st.get("MainThread", ()))]
        if len(stacks) != 1 or not in_sleep:
            raise AssertionError(f"{len(stacks)} step_hang dumps, the main "
                                 f"thread in the chaos sleep in "
                                 f"{len(in_sleep)}")
        if b["start"] != drain_step or c["start"] < SAVE_EVERY * 2:
            raise AssertionError(f"launch 2 started at {b['start']} (the "
                                 f"drain left {drain_step}), its relaunch "
                                 f"at {c['start']}")
        if (sorted(c["steps"]) != list(range(c["start"] + 1,
                                             STANDALONE_STEPS + 1))
                or sorted(b["steps"]) != list(range(drain_step + 1,
                                                    HANG_AT + 1))):
            raise AssertionError(f"steps: launch 2 {sorted(b['steps'])}, "
                                 f"relaunch {sorted(c['steps'])}")
        got = [(n, r) for run in (a, b, c) for n, r in run["steps"].items()]
        same = {f"{name} {n}": (r[1], r[2]) == ref[n - 1]
                for name, run in (("drained", a), ("hung", b),
                                  ("relaunched", c))
                for n, r in run["steps"].items()}
        out["same_bits"] = same
        out["reference"] = ref_from
        out["starts"] = [a["start"], b["start"], c["start"]]
        out["sources"] = [a["source"], b["source"], c["source"]]
        log(f"faults runs: starts {out['starts']}, sources "
            f"{out['sources']}, steps against {ref_from}: {json.dumps(same)}")
        if not all(same.values()) or len(got) != len(same):
            raise AssertionError(f"steps against {ref_from}: {same}")
        t_last = b["steps"][HANG_AT][0]
        t_fired = b["marks"]["watchdog_fired"][0]
        t_failed = _first(lines2, r"worker failed \(exit -6, hang\); "
                                  r"backing")
        spawn_ts = [ts for ts, t in lines2 if t.startswith("spawning")]
        t_relaunched = spawn_ts[-1]
        first = min(c["steps"])
        hang = {
            "watchdog_s": HANG_WATCHDOG_S, "hang_sleep_s": HANG_SLEEP_S,
            "last_step_to_abort_s": t_fired - t_last,
            "since_step_6_to_abort_s": t_fired - b["steps"][HANG_AT - 1][0],
            "abort_to_agent_s": t_failed - t_fired,
            "agent_to_relaunch_s": t_relaunched - t_failed,
            "relaunch_to_restored_s": c["times"]["restored"]
            - t_relaunched,
            "of_which_start_and_import_s": c["times"]["imported"]
            - t_relaunched,
            "restore_source": c["source"],
            # the relaunch replays the hang after its first step's line,
            # inside the watchdog's first-step budget
            "replayed_hang_to_done_s": c["marks"]["done"][0]
            - c["marks"]["hang_start"][0],
            "last_step_to_first_resumed_step_s": c["steps"][first][0]
            - t_last}
        out["hang"] = hang
        log(f"faults hang (watchdog {HANG_WATCHDOG_S:.0f} s): "
            f"{json.dumps(hang)} ({smi})")

        # launches: each process's own, the steps it finished
        out["launches"] = {}
        for name, run, steps in (("drained", a, len(a["steps"])),
                                 ("hung", b, HANG_AT - 1 - b["start"]),
                                 ("relaunched", c, len(c["steps"]))):
            want = _expected_launches(cfg, steps)
            if run.get("launches") != want:
                raise AssertionError(f"{name} worker launches "
                                     f"{run.get('launches')}, want {want}")
            out["launches"][name] = run["launches"]
        under_agent = [r[3] for run in (a, b, c)
                       for n, r in run["steps"].items()
                       if n != run["start"] + 1 and n != HANG_AT]
        out["step_under_agent"] = {
            "median_ms": statistics.median(under_agent) * 1e3,
            "steps_ms": [t * 1e3 for t in under_agent],
            "bare_loop_median_ms": _bare_loop_median_ms(resume)}
        log(f"faults step under the agent: "
            f"{json.dumps(out['step_under_agent'])} ({smi})")

        # -- the master's goodput ledger ---------------------------------
        client = MasterClient(master.addr, node_id=99, node_rank=-1)
        snap = client.get_goodput()
        buckets = snap.get("buckets", {})
        elapsed = snap.get("elapsed_rank_seconds", 0.0)
        covered = sum(buckets.values())
        out["goodput"] = {"buckets": buckets, "elapsed_rank_seconds":
                          elapsed, "goodput_fraction":
                          snap.get("goodput_fraction"),
                          "incarnations": snap.get("incarnations")}
        log(f"faults goodput: {json.dumps(out['goodput'])} ({smi})")
        log(render_snapshot(snap))
        # the ledger books the drain twice (ROADMAP Queue C, both
        # packages): drain + checkpoint_stall against the window they
        # share, ready for the fix's check
        out["drain_accounting"] = {
            "drain_plus_checkpoint_stall_s": buckets.get("drain", 0.0)
            + buckets.get("checkpoint_stall", 0.0),
            "notice_to_exit_s": drain["notice_to_exit_s"]}
        log(f"faults drain accounting (the ledger's drain + "
            f"checkpoint_stall against the measured window): "
            f"{json.dumps(out['drain_accounting'])} ({smi})")
        if not (elapsed > 0 and abs(covered - elapsed) <= 0.05 * elapsed):
            raise AssertionError(f"goodput buckets cover {covered:.3f} of "
                                 f"{elapsed:.3f} rank-seconds")
        if not (buckets.get("drain", 0) > 0
                and 0 < buckets.get("hang", 0) <= HANG_WATCHDOG_S + 1e-3):
            raise AssertionError(f"goodput drain {buckets.get('drain')}, "
                                 f"hang {buckets.get('hang')} (watchdog "
                                 f"{HANG_WATCHDOG_S})")
        log(f"faults host memory after the run: "
            f"{json.dumps(host_memory())} ({smi})")
    finally:
        if client is not None:
            client.close()
        master.stop()
        ctx.update(hang_watchdog_s=saved_hang_s)
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# observe: what the master sees of the card
# ---------------------------------------------------------------------------

# the master's diagnosis rounds and tsdb samples, seconds (the JAX
# defaults are 30 and 5); every other knob keeps its default
OBSERVE_INTERVAL_S = 2.0
# steps of the worker, and the chaos `slow` fault: from step
# OBSERVE_SLOW_AT on, each step sleeps OBSERVE_SLOW_S after its loss
OBSERVE_STEPS = 46
OBSERVE_SLOW_AT = 37
OBSERVE_SLOW_S = 1.5
# the clean steps' median against the llama1b phase's, and a trace
# group's phases against the period to the next step's start
OBSERVE_STEP_TOL = 0.01
OBSERVE_PHASE_TOL = 0.05
# the kernels the Llama-1B step launches, by their CUDA names
TRAINING_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_kernel", "rms_fwd_kernel",
                    "rms_bwd_kernel")


def _trace_kernels(path: str) -> dict:
    """{name: count} of the kernel events in a torch.profiler Chrome
    trace."""
    with open(path) as f:
        trace = json.load(f)
    counts: dict = {}
    for event in trace.get("traceEvents", []):
        if event.get("cat") == "kernel":
            name = event.get("name", "")
            counts[name] = counts.get(name, 0) + 1
    return counts


def _series_coverage(client, name: str, t0: float, t1: float,
                     pause: tuple) -> dict:
    """A series' raw points (every label set) over training [t0, t1]:
    their count, and the largest gap between neighbours (the ends of the
    span included) outside ``pause``, the capture's stop and export,
    when the worker trains and reports nothing."""
    payload = client.query_timeseries(name=name)
    stamps = sorted(p[0] for series in payload.get("series", ())
                    for p in series["points"] if t0 <= p[0] <= t1)
    edges = [t0] + stamps + [t1]
    gaps = [b - a for a, b in zip(edges, edges[1:])
            if not (a < pause[1] and b > pause[0])]
    return {"points": len(stamps), "max_gap_s": max(gaps, default=0.0)}


def phase_observe(smi: str, llama1b: dict) -> dict:
    """The master observes the card: Llama-1B under the port's master and
    agent with its monitors; the step reports' HBM watermark, the
    relayed card stats, the time series, the step traces, the diagnosis
    engine's profile:0 capture and its throughput_collapse under a slow
    fault (see the module docstring)."""
    import glob
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    t_phase = t_ref = time.monotonic()
    ref = _reference_prefix(cfg, OBSERVE_STEPS)
    log(f"observe: the reference run of {OBSERVE_STEPS} steps took "
        f"{time.monotonic() - t_ref:.1f} s")
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    ctx = Context.singleton()
    saved = {k: getattr(ctx, k) for k in ("diagnosis_interval_s",
                                          "tsdb_sample_interval_s")}
    ctx.update(diagnosis_interval_s=OBSERVE_INTERVAL_S,
               tsdb_sample_interval_s=OBSERVE_INTERVAL_S)
    master = JobMaster(host="127.0.0.1")
    # what reaches the master: every step report and resource report,
    # with the master's receive time
    seen = {"steps": [], "resources": []}
    report = master.servicer.report

    def recording_report(request):
        if isinstance(request, msg.GlobalStepReport):
            seen["steps"].append((time.time(), request))
        elif isinstance(request, msg.NodeResourceStats):
            seen["resources"].append((time.time(), request))
        return report(request)

    master.servicer.report = recording_report
    master.prepare()
    client = None
    out = {"card": smi}
    _free_memory()
    try:
        log_path, err = f"{tmp}/worker.log", f"{tmp}/agent.err"
        t_launch = time.time()
        code = _launch_agent(
            master, ["--config", "llama_1b", "--steps", str(OBSERVE_STEPS),
                     "--report-interval", "1", "--log-file", log_path],
            {"DLROVER_TPU_CHAOS": f"slow:worker:0@{OBSERVE_SLOW_AT}:"
                                  f"{OBSERVE_SLOW_S}",
             "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos",
             "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"},
            f"{tmp}/agent.out", err, tmp, repo,
            run_args=("--monitor-interval", "1"))
        lines = _agent_lines(err)
        tail = "\n".join(t for _, t in lines[-15:])
        out["agent_run_s"] = time.time() - t_launch
        if code != 0:
            raise AssertionError(f"observe: agent exited {code}: {tail}")
        runs = _worker_log(log_path)
        if len(runs) != 1 or sorted(runs[0]["steps"]) != list(
                range(1, OBSERVE_STEPS + 1)):
            raise AssertionError(f"observe: {len(runs)} incarnations, "
                                 f"steps {[sorted(r['steps']) for r in runs]}")
        run = runs[0]
        steps = run["steps"]
        same = {n: (r[1], r[2]) == ref[n - 1] for n, r in steps.items()}
        out["same_bits"] = all(same.values())
        log(f"observe losses against an uninterrupted in-process run: "
            f"{json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"observe: steps against the reference "
                                 f"run: {same}")
        want = _expected_launches(cfg, OBSERVE_STEPS)
        if run.get("launches") != want:
            raise AssertionError(f"observe: launches {run.get('launches')},"
                                 f" want {want}")
        out["launches"] = run["launches"]
        client = MasterClient(master.addr, node_id=99, node_rank=-1)

        # -- the HBM watermark: the master's step reports against the
        #    worker's own allocator peak at the same step ------------------
        peaks, reserved = {}, {}
        with open(log_path) as f:
            for line in f:
                _, _, text = line.rstrip("\n").partition(" ")
                if text.startswith("worker_allocator_peak "):
                    rec = json.loads(text.split(" ", 1)[1])
                    peaks[rec["steps"]] = rec["bytes"]
                    reserved[rec["steps"]] = rec["reserved_bytes"]
        reported = {r.step: r.hbm_peak_bytes for _, r in seen["steps"]}
        pairs = {n: (reported[n], peaks[n]) for n in peaks if n in reported}
        hbm = {"steps_compared": len(pairs),
               "equal": all(a == b for a, b in pairs.values()),
               "allocated_peak_bytes": max(peaks.values(), default=0),
               "reserved_peak_bytes": max(reserved.values(), default=0),
               "card_total_bytes": torch.cuda.mem_get_info()[1]}
        out["hbm"] = hbm
        log(f"observe hbm: {json.dumps(hbm)} ({smi})")
        if len(pairs) < OBSERVE_STEPS - 1 or not hbm["equal"]:
            raise AssertionError(f"observe: the step reports' hbm_peak_bytes"
                                 f" against the worker's allocator peak: "
                                 f"{pairs}")
        total_mb = hbm["card_total_bytes"] / 2 ** 20
        relayed = [c for _, r in seen["resources"] for c in r.chip_stats]
        with_card = [c for c in relayed if c.hbm_used_mb > 0
                     and abs(c.hbm_total_mb - total_mb) < 1.0]
        out["resource_reports"] = {
            "reports": len(seen["resources"]),
            "with_card_stats": len(with_card),
            "hbm_used_mb": [c.hbm_used_mb for c in with_card],
            "hbm_total_mb": total_mb,
            "duty_cycle_pct": [c.duty_cycle_pct for c in with_card]}
        log(f"observe relayed card stats: "
            f"{json.dumps(out['resource_reports'])} ({smi})")
        if not with_card:
            raise AssertionError(f"observe: no NodeResourceStats carried the"
                                 f" card's use and total: {relayed}")

        # -- diagnosis: the profile:0 capture and the collapse ------------
        reports = client.get_diagnosis_reports()
        out["diagnosis"] = [{k: r[k] for k in ("rule", "severity", "ts",
                                               "summary", "actions")}
                            for r in reports]
        log(f"observe diagnosis reports: {json.dumps(out['diagnosis'])}")
        profile = [r for r in reports if r["rule"] == "critical_path"
                   and "profile:0" in r["actions"]]
        pressure = [r for r in reports if r["rule"] == "hbm_pressure"]
        t_slow = steps[OBSERVE_SLOW_AT - 1][0]
        collapse = [r for r in reports if r["rule"] == "throughput_collapse"
                    and r["severity"] == "critical" and r["ts"] >= t_slow]
        if not profile or pressure or not collapse:
            raise AssertionError(f"observe: critical_path profile:0 "
                                 f"{len(profile)}, hbm_pressure "
                                 f"{len(pressure)}, throughput_collapse "
                                 f"under the slow fault {len(collapse)}")
        captures = glob.glob(f"{tmp}/dlrover-tpu-profiles-*/"
                             f"capture-*/manifest.json")
        if len(captures) != 1:
            raise AssertionError(f"observe: {len(captures)} captures")
        with open(captures[0]) as f:
            manifest = json.load(f)
        trace_path = os.path.join(os.path.dirname(captures[0]),
                                  "trace.json")
        kernels = (_trace_kernels(trace_path)
                   if os.path.exists(trace_path) else {})
        named = {k: sum(c for n, c in kernels.items() if k in n)
                 for k in TRAINING_KERNELS}
        first = manifest["start_step"] + 1
        captured = list(range(first, first + manifest["num_steps"]))
        # evidence to action: the start of the fault's first step to the
        # collapse report, and the profile:0 report to the written trace
        out["collapse_after_fault_s"] = collapse[0]["ts"] - t_slow
        out["profile"] = {
            "status": manifest["status"], "steps": captured,
            "num_steps": manifest["num_steps"],
            "trace_bytes": manifest.get("trace_bytes"),
            "start_s": manifest.get("start_s"),
            "stop_and_export_s": manifest.get("stop_s"),
            "kernel_events": named,
            "reported_after_launch_s": profile[0]["ts"] - t_launch,
            "report_to_written_trace_s": manifest["finished_at"]
            - profile[0]["ts"],
            "collapse_after_fault_s": out["collapse_after_fault_s"]}
        log(f"observe profile capture: {json.dumps(out['profile'])} "
            f"({smi})")
        if (manifest["status"] != "ok"
                or manifest["num_steps"] != ctx.diagnosis_profile_steps
                or not all(named.values())):
            raise AssertionError(f"observe: capture {manifest}, kernels "
                                 f"{named}")
        if captured[-1] >= OBSERVE_SLOW_AT - 1:
            raise AssertionError(f"observe: the capture ({captured}) ran "
                                 f"into the slow fault at "
                                 f"{OBSERVE_SLOW_AT}")

        # -- step traces --------------------------------------------------
        traces = client.query_steptrace()
        groups = {g["step"]: g for g in traces.get("steps", ())}
        counted = [g["step"] for g in traces.get("steps", ())]
        # a step's wall time is the period from its start to the next
        # step's start on the trace's own clock, and all its phases,
        # data_wait included, must account for it. The capture's start
        # and its trace's export run at two step boundaries outside any
        # phase: those two periods are reported apart. The loop's
        # young-generation collection (after the first step and every
        # GC_EVERY_STEPS) is another such piece of a boundary: the time
        # the worker logs for it leaves the period. The last step has no
        # next start.
        boundaries = {"capture_start": captured[0] - 1,
                      "capture_stop": captured[-1]}
        collections = run["collections"]
        misses, waits, gaps, syncs = {}, {}, {}, {}
        for n in steps:
            group = groups.get(n)
            if group is None:
                misses[n] = "missing"
                continue
            phases = [seg for lane in group["lanes"]
                      for seg in lane["phases"]]
            waits[n] = sum(d for name, _, d in phases
                           if name == "data_wait")
            # the boundary's host work before the save: the step
            # report's RPCs to this process's master
            syncs[n] = sum(d for name, _, d in phases
                           if name == "host_sync")
            if group["gating_rank"] != 0:
                misses[n] = ("gating rank", group["gating_rank"])
            if n + 1 not in groups:
                continue
            total = sum(d for _, _, d in phases)
            wall = (groups[n + 1]["t0"] - group["t0"]
                    - collections.get(n, 0.0))
            gaps[n] = wall - total
            if (n not in boundaries.values()
                    and abs(total - wall) > OBSERVE_PHASE_TOL * wall):
                misses[n] = (total, wall)
        outside = [g for n, g in gaps.items()
                   if n not in boundaries.values()]
        out["steptrace"] = {
            "groups": len(counted),
            "summary": traces.get("summary"),
            "data_wait_s": {"first": waits.get(1),
                            "max_after_first": max(
                                (w for n, w in waits.items() if n > 1),
                                default=0.0)},
            "collections_ms": {n: c * 1e3 for n, c in collections.items()},
            "host_sync_ms": {
                "median": (statistics.median(syncs.values()) * 1e3
                           if syncs else None),
                "max": max(syncs.values(), default=0.0) * 1e3},
            "untraced_between_steps_ms": {
                "median": statistics.median(outside) * 1e3,
                "max": max(outside) * 1e3,
                **{k: gaps[n] * 1e3 for k, n in boundaries.items()
                   if n in gaps}},
            "mismatches": misses}
        log(f"observe step traces: {json.dumps(out['steptrace'])}")
        if misses or sorted(counted) != sorted(steps):
            raise AssertionError(f"observe: step traces {sorted(counted)}: "
                                 f"{misses}")

        # -- time series: a point per sample interval while training ------
        t_first = min(t for t, _ in seen["steps"])
        t_last = max(t for t, _ in seen["steps"])
        pause = (steps[captured[-1]][0], steps[captured[-1] + 1][0])
        series = {name: _series_coverage(client, name, t_first, t_last,
                                         pause)
                  for name in ("dlrover_tpu_worker_step_time_seconds",
                               "dlrover_tpu_training_tokens_per_second",
                               "dlrover_tpu_training_mfu",
                               "dlrover_tpu_worker_mfu",
                               "dlrover_tpu_worker_hbm_peak_mb")}
        out["timeseries"] = {"training_span_s": t_last - t_first,
                             "export_pause_s": pause[1] - pause[0],
                             "series": series}
        log(f"observe time series: {json.dumps(out['timeseries'])}")
        sparse = {n: c for n, c in series.items()
                  if c["max_gap_s"] > 1.5 * OBSERVE_INTERVAL_S}
        if sparse:
            raise AssertionError(f"observe: series without a point every "
                                 f"{OBSERVE_INTERVAL_S} s of training: "
                                 f"{sparse}")

        # -- step time outside the capture and the fault -----------------
        after = captured[-1] + 1
        clean = {n: r[3] * 1e3 for n, r in steps.items()
                 if 2 < n < OBSERVE_SLOW_AT and n not in captured
                 and n != after}
        median = statistics.median(clean.values())
        base = llama1b.get("step_median_ms")
        times = {
            "clean_median_ms": median, "clean_steps_ms": clean,
            "captured_steps_ms": [steps[n][3] * 1e3 for n in captured],
            "captured_over_clean": statistics.median(
                steps[n][3] for n in captured) * 1e3 / median,
            "first_after_capture_ms": steps[after][3] * 1e3,
            "slow_steps_ms": [steps[n][3] * 1e3
                              for n in range(OBSERVE_SLOW_AT,
                                             OBSERVE_STEPS + 1)],
            "llama1b_median_ms": base if base else "not measured"}
        out["step_time"] = times
        log(f"observe step time: {json.dumps(times)} ({smi})")
        if base:
            band = (base * (1 - OBSERVE_STEP_TOL),
                    base * (1 + OBSERVE_STEP_TOL))
            spread = max(band[1], max(clean.values()))
            # the first step after the capture must not be slower than
            # the clean steps and the band (CUPTI released); faster is
            # no fault
            if not (band[0] <= median <= band[1]
                    and times["first_after_capture_ms"] <= spread):
                raise AssertionError(
                    f"observe: clean median {median:.2f} ms against the "
                    f"llama1b median {base:.2f} ms, the first step after "
                    f"the capture {times['first_after_capture_ms']:.2f} ms "
                    f"(the clean steps' and the band's top {spread:.2f})")
        log(f"observe: the phase took {time.monotonic() - t_phase:.1f} s "
            f"(the reference run, the worker under the agent "
            f"{out['agent_run_s']:.1f} s, the checks)")
    finally:
        if client is not None:
            client.close()
        master.stop()
        ctx.update(**saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out

# -- failover: the master survives its own death ----------------------------
FAILOVER_KILL_AT = 10
FAILOVER_SAVE_EVERY = 8
# steps that must follow the agent's reconnect (each runs at the
# degraded period of ROADMAP C1, ≈1.7 s on the card)
FAILOVER_AFTER_RECONNECT = 5
# the agent's poll cadence, cut from its 5 s default, and the deadline of
# every master RPC of the agent and the worker, cut from 30 s: an RPC to
# a dead master waits out its whole deadline (the channel waits for a
# connection), so at the defaults the agent needs 2 polls x 3 attempts x
# 30 s to declare the master lost, and every step report of the worker
# blocks 30 s
FAILOVER_MONITOR_S = 1.0
FAILOVER_RPC_TIMEOUT_S = 0.5
# the components a snapshot holds that the promoted master must restore
# exactly
FAILOVER_COMPONENTS = ("rendezvous", "task_manager", "kv_store",
                       "speed_monitor", "goodput", "diagnosis")


def failover_budget(monitor_s: float, rpc_timeout_s: float,
                    kill_at: int = FAILOVER_KILL_AT,
                    checkpoint: bool = True) -> dict:
    """Upper bounds, from the code, on the seconds from the primary's
    death to the agent's master-lost mode (``detect_s``: two failed
    ``num_nodes_waiting`` polls, each 3 attempts of a whole RPC deadline
    and the retry backoff, after a monitor wait), to the standby's
    promotion (``promote_s``: ``standby_promote_failures`` probes of
    ``max(1, interval)`` s, an interval apart) and to the reconnect
    (``reconnect_s``: the later of the two, one failed dial of the old
    address and its backoff, one good dial); the least period of a
    worker step while its master is dead (``degraded_step_s``: its step
    report, its step-trace flush and, with a ``checkpoint``, its query of
    the master's data-shard position each wait out the deadline), and
    the worker's steps: the kill's step, the outage's steps at that
    period, and FAILOVER_AFTER_RECONNECT more."""
    from dlrover_tpu_torch.common.config import Context

    ctx = Context.singleton()
    backoff = ctx.rpc_backoff_s
    poll = 3 * rpc_timeout_s + backoff * (1 + 2)
    detect = 2 * (monitor_s + poll)
    probe = max(1.0, ctx.standby_health_interval_s)
    promote = ctx.standby_promote_failures * (
        probe + ctx.standby_health_interval_s)
    reconnect = max(detect, promote) + 2 * rpc_timeout_s + 2 * backoff
    degraded = (3 if checkpoint else 2) * rpc_timeout_s
    outage_steps = math.ceil(reconnect / degraded)
    return {"detect_s": detect, "promote_s": promote,
            "reconnect_s": reconnect, "degraded_step_s": degraded,
            "outage_steps": outage_steps,
            "steps": kill_at + outage_steps + FAILOVER_AFTER_RECONNECT}


def _matches(lines: list, pattern: str) -> list:
    import re

    return [(ts, m) for ts, text in lines
            for m in [re.search(pattern, text)] if m]


def _worker_children(pid: int) -> set:
    """The worker processes (llama_train.py) among ``pid``'s children."""
    found = set()
    for kid in _children(pid):
        try:
            with open(f"/proc/{kid}/cmdline", "rb") as f:
                if b"llama_train.py" in f.read():
                    found.add(kid)
        except OSError:
            continue
    return found


def _wait_for_file(path: str, proc, timeout_s: float, what: str) -> None:
    import os

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if os.path.exists(path):
            return
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited {proc.returncode}")
        time.sleep(0.05)
    raise AssertionError(f"{what}: no {path} after {timeout_s} s")


def failover_drill(tmp: str, repo: str, worker_args: list, steps: int,
                   kill_at: int, monitor_s: float, env_extra: dict,
                   timeout_s: float = FAILOVER_WAIT_S,
                   worker_chaos: str = "") -> dict:
    """A primary master (``python -m dlrover_tpu_torch.master.job_master
    --state-dir S --bootstrap-file B`` with ``kill:master:0@kill_at``),
    a hot standby (the same with ``--standby``) and ``python -m
    dlrover_tpu_torch.run`` finding the master through B, around
    ``llama_train.py`` with ``worker_args``: the primary SIGKILLs itself
    at the worker's step-``kill_at`` report, the standby promotes, the
    agent reconnects and the worker trains on (``worker_chaos``, a chaos
    spec for the worker alone). Gates 1-3 and 5 of the
    failover phase (see the module docstring) raise here; returns the
    worker's run, the marks and the promoted master's answers."""
    import os

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.state_backend import MasterStateBackend

    state, boot = f"{tmp}/state", f"{tmp}/master.addr"
    paths = {n: f"{tmp}/{n}" for n in (
        "primary.out", "primary.err", "standby.out", "standby.err",
        "agent.out", "agent.err", "worker.log")}
    base = dict(os.environ, PYTHONPATH=repo, **env_extra)
    base.pop("DLROVER_TPU_CHAOS", None)
    master_cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.job_master",
                  "--state-dir", state, "--bootstrap-file", boot]
    procs = {}

    def start(name, cmd, env):
        with open(paths[f"{name}.out"], "w") as fo, \
                open(paths[f"{name}.err"], "w") as fe:
            procs[name] = subprocess.Popen(cmd, cwd=repo, env=env,
                                           stdout=fo, stderr=fe)

    out = {"steps": steps, "kill_at": kill_at}
    try:
        start("primary", master_cmd,
              dict(base, DLROVER_TPU_CHAOS=f"kill:master:0@{kill_at}",
                   DLROVER_TPU_CHAOS_STATE=f"{tmp}/chaos"))
        _wait_for_file(boot, procs["primary"], 60, "the primary")
        start("standby", master_cmd + ["--standby"], base)
        deadline = time.time() + 60
        while not _matches(_agent_lines(paths["standby.err"]),
                           r"hot standby watching"):
            if time.time() > deadline or procs["standby"].poll() is not None:
                raise AssertionError("the standby did not start watching")
            time.sleep(0.05)
        t_launch = time.time()
        start("agent", [sys.executable, "-m", "dlrover_tpu_torch.run",
                        "--devices-per-node", "1",
                        "--monitor-interval", str(monitor_s),
                        "dlrover_tpu_torch/examples/llama_train.py"]
              + list(worker_args)
              + ["--steps", str(steps), "--report-interval", "1",
                 "--log-file", paths["worker.log"]],
              dict(base, DLROVER_TPU_MASTER_BOOTSTRAP_FILE=boot,
                   **({"DLROVER_TPU_CHAOS": worker_chaos,
                       "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos"}
                      if worker_chaos else {})))
        workers = set()
        deadline = time.time() + timeout_s
        while procs["agent"].poll() is None and time.time() < deadline:
            workers |= _worker_children(procs["agent"].pid)
            time.sleep(0.05)
        if procs["agent"].poll() is None:
            raise AssertionError(f"failover: the agent ran past "
                                 f"{timeout_s} s")
        out["agent_run_s"] = time.time() - t_launch
        out["agent_exit"] = procs["agent"].returncode
        out["primary_exit"] = procs["primary"].poll()
        out["worker_pids_seen"] = sorted(workers)
        with open(boot) as f:
            out["bootstrap"] = json.load(f)
        # the promoted master, asked before it is stopped
        client = MasterClient(out["bootstrap"]["addr"], node_id=99,
                              node_rank=-1)
        try:
            out["goodput"] = client.get_goodput()
            out["history"] = client.query_timeseries(
                name="dlrover_tpu_worker_step_time_seconds",
                labels={"node": "0"}, resolution_s=10.0)
        finally:
            client.close()
    finally:
        for name in ("agent", "standby", "primary"):
            proc = procs.get(name)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    lines = {n: _agent_lines(paths[f"{n}.err"])
             for n in ("primary", "standby", "agent")}
    tail = {n: "\n".join(t for _, t in lines[n][-12:]) for n in lines}

    # gate 1: the primary died by its own SIGKILL at the kill step's
    # report
    fired = _matches(lines["primary"],
                     r"chaos: SIGKILL self \(master-0\) at step (\d+)")
    if (out["primary_exit"] != -signal.SIGKILL or len(fired) != 1
            or int(fired[0][1].group(1)) != kill_at):
        raise AssertionError(f"failover: primary exit {out['primary_exit']}"
                             f", chaos {[m.group(0) for _, m in fired]}: "
                             f"{tail['primary']}")
    t_kill = fired[0][0]
    out["kill_ts"] = t_kill

    # gate 2: one promotion, at the loaded snapshot's generation + 1,
    # and the bootstrap file names it
    restored = _matches(lines["standby"],
                        r"restored from snapshot v(\d+) \(generation (\d+),"
                        r" (\d+) hot mutations replayed\)")
    promoted = _matches(lines["standby"],
                        r"PROMOTED in ([\d.]+)s: serving at (\S+) \(coord "
                        r"(\S+)\) as generation (\d+)")
    failed_probes = _matches(lines["standby"],
                             r"primary health probe failed \((\d+)/(\d+)")
    if len(promoted) != 1 or len(restored) != 1:
        raise AssertionError(f"failover: {len(promoted)} promotions, "
                             f"{len(restored)} restores: {tail['standby']}")
    version = int(restored[0][1].group(1))
    replayed = int(restored[0][1].group(3))
    generation = int(promoted[0][1].group(4))
    backend = MasterStateBackend(state)
    loaded = backend.load_version(version)
    written = backend.load_version(version + 1)
    boot_want = {"addr": promoted[0][1].group(2),
                 "coord_addr": promoted[0][1].group(3),
                 "generation": generation}
    if (generation != loaded["generation"] + 1
            or written["generation"] != generation
            or out["bootstrap"] != boot_want):
        raise AssertionError(f"failover: promoted generation {generation} "
                             f"from snapshot v{version} at generation "
                             f"{loaded['generation']}, its first snapshot "
                             f"{written['generation']}, bootstrap "
                             f"{out['bootstrap']} against {boot_want}")
    out["snapshot"] = {"loaded_version": version,
                       "loaded_generation": loaded["generation"],
                       "promoted_generation": generation,
                       "hot_mutations_replayed": replayed,
                       "versions_on_disk": len(backend.versions())}

    # gate 3: master-lost mode, one reconnect with the world intact, no
    # new round, no restart
    lost = _matches(lines["agent"], r"entering master-lost mode")
    reconnected = _matches(lines["agent"],
                           r"reconnected to master (\S+) \(generation "
                           r"(\d+), world intact=(\w+)\)")
    spawns = _matches(lines["agent"], r"spawning worker \(round (\d+),")
    if (len(lost) != 1 or len(reconnected) != 1
            or reconnected[0][1].group(3) != "True"
            or reconnected[0][1].group(1) != boot_want["addr"]
            or int(reconnected[0][1].group(2)) != generation
            or [m.group(1) for _, m in spawns] != ["0"]
            or out["agent_exit"] != 0):
        raise AssertionError(
            f"failover: agent exit {out['agent_exit']}, master-lost "
            f"{len(lost)}, reconnects "
            f"{[m.group(0) for _, m in reconnected]}, spawns "
            f"{[m.group(0) for _, m in spawns]}: {tail['agent']}")
    runs = _worker_log(paths["worker.log"])
    run = runs[0] if len(runs) == 1 else {}
    order = list(run.get("steps", {}))
    pid_at_exit = run.get("times", {}).get("pid")
    if (len(runs) != 1 or run["start"] != 0
            or order != list(range(1, steps + 1))
            or run["pid"] is None or pid_at_exit != run["pid"]
            or out["worker_pids_seen"] != [run["pid"]]):
        raise AssertionError(
            f"failover: {len(runs)} incarnations, starts "
            f"{[r['start'] for r in runs]}, steps {order}, pids "
            f"{run.get('pid')} / {pid_at_exit} / {out['worker_pids_seen']}")
    t_lost, t_reconnect = lost[0][0], reconnected[0][0]
    after = [n for n in order if run["steps"][n][0] > t_reconnect]
    out["run"] = run
    out["steps_after_reconnect"] = len(after)
    if len(after) < FAILOVER_AFTER_RECONNECT:
        raise AssertionError(f"failover: {len(after)} steps after the "
                             f"reconnect, want {FAILOVER_AFTER_RECONNECT}")

    # gate 5: the promoted master's state is the snapshot it loaded,
    # component by component (a hot key the mutation log replayed over
    # the snapshot aside), and its tsdb holds the sidecar's points from
    # before the kill
    differ = [k for k in FAILOVER_COMPONENTS
              if k != "kv_store" and loaded.get(k) != written.get(k)]
    kv_loaded, kv_written = loaded["kv_store"], written["kv_store"]
    if replayed == 0:
        kv_same = kv_loaded == kv_written
    else:
        cold = [k for k in set(kv_loaded) | set(kv_written)
                if not k.startswith("coord/")]
        kv_same = all(kv_loaded.get(k) == kv_written.get(k) for k in cold)
    if differ or not kv_same:
        raise AssertionError(f"failover: the promoted master's first "
                             f"snapshot v{version + 1} differs from the "
                             f"loaded v{version} in {differ} (kv store "
                             f"same: {kv_same})")
    before = [p for series in out["history"].get("series", ())
              for p in series["points"] if p[0] < t_kill and p[4] > 0]
    out["tsdb_points_before_kill"] = len(before)
    if not before:
        raise AssertionError(f"failover: the promoted master's tsdb holds "
                             f"no step-time point from before the kill: "
                             f"{out['history']}")

    # marks, measured and printed, not gated
    t_promoted = promoted[0][0]
    # the kill step's report is the one the primary died serving
    reports_after_kill = [n for n in order if n >= kill_at]
    with open(paths["worker.log"]) as f:
        failed_reports = sum(1 for line in f
                             if line.split(" ", 1)[-1].startswith(
                                 "step report failed"))
    out["marks"] = {
        "kill_to_first_failed_probe_s": (failed_probes[0][0] - t_kill
                                         if failed_probes else None),
        "kill_to_promoted_s": t_promoted - t_kill,
        "promotion_s": float(promoted[0][1].group(1)),
        "kill_to_master_lost_s": t_lost - t_kill,
        "kill_to_reconnect_s": t_reconnect - t_kill,
        "master_lost_to_reconnect_s": t_reconnect - t_lost}
    periods = {n: run["steps"][n][0] - run["steps"][n - 1][0]
               for n in order[1:]}

    def median_ms(ns):
        vals = [periods[n] for n in ns if n in periods]
        return statistics.median(vals) * 1e3 if vals else None

    out["step_period_ms"] = {
        "before_kill": median_ms([n for n in order
                                  if run["steps"][n][0] <= t_kill]),
        "outage": median_ms([n for n in order
                             if t_kill < run["steps"][n][0]
                             <= t_reconnect]),
        "after_reconnect": median_ms(after),
        "after_reconnect_max": max((periods[n] for n in after), default=0)
        * 1e3}
    out["step_reports"] = {
        "sent_from_the_kill_step": len(reports_after_kill),
        "failed": failed_reports,
        "reached_promoted_master": len(reports_after_kill)
        - failed_reports}
    out["goodput_buckets"] = out["goodput"].get("buckets")
    return out


def phase_failover(smi: str) -> dict:
    """Llama-1B trains through a SIGKILLed master (see the module
    docstring)."""
    import os
    import shutil
    import tempfile

    t_phase = time.monotonic()
    cfg = ckpt_config()
    budget = failover_budget(FAILOVER_MONITOR_S, FAILOVER_RPC_TIMEOUT_S)
    steps = budget["steps"]
    log(f"failover: the agent polls every {FAILOVER_MONITOR_S} s (cut from "
        f"5 s) and every master RPC of the agent and the worker has a "
        f"{FAILOVER_RPC_TIMEOUT_S} s deadline (cut from 30 s); the standby "
        f"runs at its defaults; bounds from the code: "
        f"{json.dumps(budget)}: {steps} steps, the kill at step "
        f"{FAILOVER_KILL_AT}, saves every {FAILOVER_SAVE_EVERY}")
    t_ref = time.monotonic()
    ref = _reference_prefix(cfg, steps)
    log(f"failover: the reference run took {time.monotonic() - t_ref:.1f} "
        f"s (0 when an earlier phase ran it)")
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    agent_tmp = ""
    _free_memory()
    try:
        saves = steps // FAILOVER_SAVE_EVERY
        free = shutil.disk_usage(tmp).free
        log(f"failover: checkpoints in {tmp}, {free / 1e9:.1f} GB free; "
            f"the run keeps its {saves} saves of {state_bytes / 1e9:.2f} "
            f"GB")
        if free < (saves + 0.1) * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than {saves} checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "failover")
        out = failover_drill(
            tmp, repo,
            ["--config", "llama_1b", "--layers", str(CKPT_LAYERS),
             "--save-interval",
             str(FAILOVER_SAVE_EVERY), "--ckpt-dir", f"{tmp}/ckpt"],
            steps, FAILOVER_KILL_AT, FAILOVER_MONITOR_S,
            {"TMPDIR": agent_tmp,
             "DLROVER_TPU_RPC_TIMEOUT_S": str(FAILOVER_RPC_TIMEOUT_S),
             # every snapshot stays, so the loaded one can be read back
             "DLROVER_TPU_MASTER_SNAPSHOT_RETAIN": "1000",
             # the sidecar holds the history before the kill
             "DLROVER_TPU_TSDB_SAMPLE_INTERVAL_S": "1",
             "DLROVER_TPU_TSDB_FLUSH_INTERVAL_S": "2",
             "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"})
        run = out.pop("run")
        # gate 4: every step the bits of an uninterrupted run
        same = {n: (r[1], r[2]) == ref[n - 1]
                for n, r in run["steps"].items()}
        log(f"failover losses against an uninterrupted in-process run: "
            f"{json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"failover: steps against the reference "
                                 f"run: {same}")
        want = _expected_launches(cfg, steps)
        if run.get("launches") != want:
            raise AssertionError(f"failover: launches {run.get('launches')},"
                                 f" want {want}")
        out["launches"] = run["launches"]
        out["budget"] = budget
        out.pop("history")
        out.pop("goodput")
        for key in ("marks", "step_period_ms", "step_reports",
                    "goodput_buckets", "snapshot"):
            log(f"failover {key}: {json.dumps(out[key])} ({smi})")
        out["phase_s"] = time.monotonic() - t_phase
        log(f"failover: {out['steps_after_reconnect']} steps after the "
            f"reconnect, {out['tsdb_points_before_kill']} tsdb buckets "
            f"from before the kill; the phase took {out['phase_s']:.1f} s "
            f"(the worker under the agent {out['agent_run_s']:.1f} s) "
            f"({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# the replan phase: two solo replicas of Llama-1B on the one card under
# the port's master (min 1, max 2 nodes), each a micro batch of 2; the
# top rank leaves at step 6 and the survivor re-plans to world 1. No
# interval save: the survivor's only checkpoint is the one its stop
# forces (a commit in flight would hold the leaver's exit for its whole
# 16-26 s, and the survivor trains on meanwhile). 36 steps leave room
# for the survivor's stop, which lands some steps after 6 (at 22 and at
# 31 in two runs on one machine), and for three diagnosis rounds after
# the re-plan.
REPLAN_STEPS = 36
REPLAN_LEAVE_AT = 6
REPLAN_MICRO = 2
REPLAN_MONITOR_S = 0.5
REPLAN_INTERVAL_S = 2.0
# the master's speed window (samples): the last seven step periods, clear
# of the resumed incarnation's first-step collection
REPLAN_SPEED_WINDOW = 8
REPLAN_SPEED_TOL = 0.02


def _link_stage(cache: str, step: int, dest: str) -> str:
    """Hard-link a peer cache's stage of ``step`` into a new cache
    directory ``dest`` (the same bytes, no copy), with that stage's
    manifest as the top-level one; returns ``dest``."""
    import os
    import shutil

    from dlrover_tpu_torch.checkpoint.peer_restore import MANIFEST

    stage = os.path.join(cache, f"stage-{step}")
    target = os.path.join(dest, f"stage-{step}")
    os.makedirs(target)
    for name in os.listdir(stage):
        os.link(os.path.join(stage, name), os.path.join(target, name))
    shutil.copyfile(os.path.join(stage, MANIFEST),
                    os.path.join(dest, MANIFEST))
    return dest


def _replan_reference(cfg, cache: str, ckpt_dir: str, steps: int) -> dict:
    """A solo world-1 worker in this process restored from the staged cut
    in ``cache`` (no master: the local pseudo-plan) at the survivor's
    shape (batch 8, micro 2), trained to ``steps``: its source, start
    and {step: (loss, grad_norm)}."""
    import os

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    os.environ[NodeEnv.PEER_CACHE_DIR] = cache
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
            TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                            max_micro_per_replica=REPLAN_MICRO,
                            checkpoint_dir=ckpt_dir,
                            save_interval_steps=10 ** 6,
                            report_interval_steps=0))
    finally:
        del os.environ[NodeEnv.PEER_CACHE_DIR]
    sampler, data = _sampler_and_data(cfg)
    state, start = loop.restore_or_init(0, sampler)
    out = {"source": loop.last_restore_source, "start": start}
    loop.config.max_steps = steps - start
    state, metrics = loop.run(state, data, start, sampler)
    loop.close()
    out["steps"] = {r["step"]: (r["loss"], r["grad_norm"])
                    for r in metrics["history"]}
    del state, loop
    _free_memory()
    return out


def phase_replan(smi: str) -> dict:
    """Re-planning on resize: two solo replicas of Llama-1B on the card
    under the port's master, the top rank leaving at step 6, the
    survivor re-planned to world 1 in one round (see the module
    docstring)."""
    import glob
    import os
    import re
    import shutil
    import statistics as stats
    import tempfile

    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.parallel import planner

    t_phase = time.monotonic()
    cfg = ckpt_config()
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_replan_")
    agent_tmp = ""
    ctx = Context.singleton()
    saved = {k: getattr(ctx, k) for k in ("diagnosis_interval_s",
                                          "speed_sample_window")}
    ctx.update(diagnosis_interval_s=REPLAN_INTERVAL_S,
               speed_sample_window=REPLAN_SPEED_WINDOW)
    master = JobMaster(min_nodes=1, max_nodes=2, host="127.0.0.1")
    mgr = master.servicer.rdzv_managers[RendezvousName.TRAINING]
    # both ranks alive up front: the first round cuts once, when the
    # second joins
    for rank in (0, 1):
        mgr.add_alive_node(rank)
    seen = {"model_info": [], "spans": []}
    report = master.servicer.report

    def recording_report(request):
        if isinstance(request, msg.ModelInfo):
            seen["model_info"].append(request)
        elif isinstance(request, msg.TelemetryReport) and request.spans_json:
            seen["spans"] += [(request.node_rank, s) for s in
                              json.loads(request.spans_json)]
        return report(request)

    master.servicer.report = recording_report
    note_replan = master.servicer._note_replan

    def recording_note_replan(plan):
        # the speed monitor's window right after the re-anchor
        note_replan(plan)
        seen.setdefault("replans", []).append(
            (plan, len(master.speed_monitor._samples)))

    master.servicer._note_replan = recording_note_replan
    master.prepare()
    procs, files = [], []
    out = {"card": smi}
    _free_memory()
    try:
        free = shutil.disk_usage(tmp).free
        log(f"replan: checkpoints in {tmp}, {free / 1e9:.1f} GB free; the "
            f"run needs room for two of {state_bytes / 1e9:.2f} GB")
        if free < 2 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than two checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "replan")
        logs = [f"{tmp}/rank{rank}.log" for rank in (0, 1)]
        errs = [f"{tmp}/agent{rank}.err" for rank in (0, 1)]
        env = {"DLROVER_TPU_CHAOS": f"resize:-1@{REPLAN_LEAVE_AT}",
               "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos",
               "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"}
        t_launch = time.time()
        for rank in (0, 1):
            proc, pair = _spawn_agent(
                master, ["--config", "llama_1b", "--layers",
                         str(CKPT_LAYERS), "--steps",
                         str(REPLAN_STEPS), "--save-interval",
                         str(10 ** 6), "--report-interval", "1",
                         "--max-micro", str(REPLAN_MICRO), "--solo-replica",
                         "--ckpt-dir", f"{tmp}/ckpt", "--log-file",
                         logs[rank]],
                env, f"{tmp}/agent{rank}.out", errs[rank], agent_tmp, repo,
                run_args=("--node-rank", str(rank), "--devices-per-node",
                          "1", "--monitor-interval", str(REPLAN_MONITOR_S)))
            procs.append(proc)
            files += pair
        # watch the run: the plans the master stamps, and the survivor's
        # staged cut, linked aside as soon as its second incarnation
        # starts (the agent removes its cache when it exits)
        plans, ref_cache, rounds_at_resize = [], "", None
        deadline = time.monotonic() + REPLAN_WAIT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"replan: the agents outlived "
                                     f"{REPLAN_WAIT_S:.0f} s")
            plan = mgr.last_shard_plan
            if plan and (not plans or plan != plans[-1]):
                plans.append(plan)
            if rounds_at_resize is None and 1 not in mgr.alive_nodes:
                rounds_at_resize = mgr.rdzv_round
            runs = _worker_log(logs[0]) if os.path.exists(logs[0]) else []
            if not ref_cache and len(runs) > 1:
                step = runs[1]["start"]
                caches = [c for c in glob.glob(
                    f"{agent_tmp}/dlrover-tpu-agent-*/peer_cache")
                    if os.path.isdir(f"{c}/stage-{step}")]
                if len(caches) != 1:
                    raise AssertionError(f"replan: stage {step} in "
                                         f"{caches}")
                ref_cache = _link_stage(caches[0], step,
                                        f"{agent_tmp}/reference_cache")
            time.sleep(0.2)
        out["agents_s"] = time.time() - t_launch
        codes = [p.returncode for p in procs]
        for f in files:
            f.close()
        tails = {rank: "\n".join(t for _, t in _agent_lines(errs[rank])[-10:])
                 for rank in (0, 1)}
        if codes != [0, 0]:
            raise AssertionError(f"replan: agents exited {codes}: {tails}")
        survivor, leaver = _worker_log(logs[0]), _worker_log(logs[1])
        if len(survivor) != 2 or len(leaver) != 1:
            raise AssertionError(f"replan: {len(survivor)} survivor and "
                                 f"{len(leaver)} leaver incarnations")
        first, resumed = survivor
        stop = resumed["start"]
        out["stop_step"] = stop
        log(f"replan: the leaver stopped after step "
            f"{max(leaver[0]['steps'])}, the survivor's stop forced its "
            f"save at step {stop}; its resumed incarnation trained "
            f"{sorted(resumed['steps'])}")
        if (sorted(leaver[0]["steps"]) != list(range(1, REPLAN_LEAVE_AT + 1))
                or stop < REPLAN_LEAVE_AT or stop > REPLAN_STEPS - 4
                or sorted(resumed["steps"]) != list(
                    range(stop + 1, REPLAN_STEPS + 1))):
            raise AssertionError(
                f"replan: leaver steps {sorted(leaver[0]['steps'])}, "
                f"survivor {sorted(first['steps'])} then "
                f"{sorted(resumed['steps'])}")

        # gate 1: the plans, world 2 → 1, a new epoch, feasible; the
        # survivor's incarnations applied the two (the second's plan, an
        # RPC after the cut, carries the round of the cut as generation)
        applied = []
        with open(logs[0]) as f:
            for line in f:
                m = re.search(r"shard plan applied \((\S+)\): .* "
                              r"generation=(\d+) epoch=(\d+)", line)
                if m:
                    applied.append((m.group(1), int(m.group(2)),
                                    int(m.group(3))))
        out["applied"] = applied
        two = [p for p in plans if p["world_size"] == 2]
        one = [p for p in plans if p["world_size"] == 1]
        out["plans"] = [{k: p[k] for k in ("world_size", "epoch",
                                           "generation", "mesh",
                                           "global_batch", "feasible",
                                           "predicted_step_s")}
                        for p in plans]
        log(f"replan plans stamped: {json.dumps(out['plans'])}")
        if (not two or not one or plans[-1] != one[-1]
                or not one[-1]["feasible"]
                or one[-1]["epoch"] <= two[-1]["epoch"]
                or [a[0] for a in applied] != ["batch", "mesh+batch"]
                or applied[1][2] != one[-1]["epoch"]):
            raise AssertionError(f"replan: plans {out['plans']}, applied "
                                 f"{applied}")
        post = dict(one[-1], generation=applied[1][1])

        # gate 2: one rendezvous round, the restore from the survivor's
        # own staged cut (no checkpoint read), the leaver's clean drain
        drained = [e for e in obs.get_flight_recorder().snapshot()
                   if e.get("name") == "node_drained"
                   and e["attrs"].get("rank") == 1]
        out["rounds"] = {"at_resize": rounds_at_resize,
                         "final": mgr.rdzv_round}
        out["restore"] = {"source": resumed["source"],
                          "timings": resumed["restore"]}
        log(f"replan restore: {json.dumps(out['restore'])}; rounds "
            f"{json.dumps(out['rounds'])}")
        if (rounds_at_resize is None or mgr.rdzv_round != rounds_at_resize + 1
                or resumed["source"] != "peer"
                or "dcp_read_s" in resumed["restore"] or not drained):
            raise AssertionError(
                f"replan: rounds {out['rounds']}, restore {out['restore']},"
                f" drained {drained}")

        # gate 3: the spans of the resize, each once, from the survivor
        priced = [s for rank, s in seen["spans"] if rank == 0
                  and s.get("name", "").startswith("replan_")
                  and (s.get("attrs") or {}).get("generation")
                  == post["generation"]]
        names = sorted(s["name"] for s in priced)
        out["spans"] = {s["name"][len("replan_"):]: s["duration_s"]
                        for s in priced}
        migrate = [s for s in priced if s["name"] == "replan_migrate"]
        log(f"replan spans of generation {post['generation']}: "
            f"{json.dumps(out['spans'])} s ({smi})")
        if (names != ["replan_migrate", "replan_plan", "replan_rebuild"]
                or migrate[0]["attrs"].get("source") != "peer"):
            raise AssertionError(f"replan: spans {priced}")

        # gate 4: the survivor's resumed steps, bit for bit a solo
        # world-1 worker restored from the same staged cut
        ckpt_ref = f"{tmp}/reference_ckpt"
        ref = _replan_reference(cfg, ref_cache, ckpt_ref, REPLAN_STEPS)
        same = {n: (r[1], r[2]) == ref["steps"].get(n)
                for n, r in resumed["steps"].items()}
        log(f"replan: the reference restored {ref['start']} from "
            f"{ref['source']}; the survivor's resumed steps against it: "
            f"{json.dumps(same)}")
        if (ref["source"] != "peer" or ref["start"] != stop
                or not all(same.values())):
            raise AssertionError(f"replan: reference {ref['source']} at "
                                 f"{ref['start']}, steps {same}")
        shared = {rank: [r["steps"][n][3] for n in range(2,
                                                          REPLAN_LEAVE_AT + 1)]
                  for rank, r in ((0, first), (1, leaver[0]))}
        out["same_bits_both_replicas"] = all(
            first["steps"][n][1:3] == leaver[0]["steps"][n][1:3]
            for n in range(1, REPLAN_LEAVE_AT + 1))

        # gate 5: the master's speed from post-resize samples only: the
        # re-plan re-anchored it (its window emptied, one card) at the
        # survivor's re-join. (A replica whose plan request follows the
        # other's first ModelInfo sees the world-2 plan re-stamped with
        # the real batch, which both packages' masters count as a
        # re-plan too: at most one such re-anchor at two cards before.)
        replans = [(p["total_devices"], n) for p, n in seen.get("replans",
                                                               [])]
        out["reanchor"] = replans
        if replans[-1:] != [(1, 0)] or replans[:-1] not in ([], [(2, 0)]):
            raise AssertionError(f"replan: re-anchors {replans}")
        monitor = master.speed_monitor
        samples = list(monitor._samples)
        speed = monitor.export_state()
        info = seen["model_info"][-1]
        tokens = 8 * cfg.max_seq_len
        window = [s for _, s in samples]
        # the survivor's own rate over the master's window, from its step
        # lines' clock: the mean period, as the master's window is a
        # mean (the median printed beside it: steps at micro 2 have
        # outliers of 10%, which part a mean from a median)
        times = {n: r[0] for n, r in resumed["steps"].items()}
        periods = [times[n] - times[n - 1] for n in window[1:]
                   if n - 1 in times]
        own_tps = tokens / stats.mean(periods)
        own_mfu = own_tps * info.flops_per_token / info.peak_flops_per_chip
        out["speed"] = {
            "window_steps": window,
            "master_tokens_per_s": monitor.tokens_per_second(),
            "master_mfu": monitor.running_mfu(),
            "survivor_tokens_per_s": own_tps, "survivor_mfu": own_mfu,
            "survivor_median_tokens_per_s": tokens / stats.median(periods),
            "master_periods_s": [b[0] - a[0] for a, b in
                                 zip(samples, samples[1:])],
            "survivor_periods_s": periods,
            "survivor_step_s": [resumed["steps"][n][3] for n in window],
            "tokens_per_step": speed["tokens_per_step"],
            "peak_flops_total": speed["peak_flops_total"]}
        log(f"replan speed: {json.dumps(out['speed'])} ({smi})")
        if (speed["tokens_per_step"] != tokens
                or speed["peak_flops_total"] != info.peak_flops_per_chip
                or not window or min(window) <= stop
                or abs(out["speed"]["master_tokens_per_s"] / own_tps - 1)
                > REPLAN_SPEED_TOL
                or abs(out["speed"]["master_mfu"] / own_mfu - 1)
                > REPLAN_SPEED_TOL):
            raise AssertionError(f"replan: speed {out['speed']}")

        # gate 6: the calibration holds the world-1 signature with its
        # samples, predicted by the planner's formula on the ModelInfo
        client = MasterClient(master.addr, node_id=99, node_rank=-1)
        try:
            calibration = client.get_plan_calibration()
            goodput = client.get_goodput()
            reports = client.get_diagnosis_reports()
        finally:
            client.close()
        entry = [e for e in calibration["table"]
                 if e["total_devices"] == 1][-1:]
        profile = planner.ModelProfile(
            param_count=info.param_count, param_bytes=info.param_bytes,
            flops_per_token=info.flops_per_token,
            peak_flops_per_chip=info.peak_flops_per_chip,
            seq_len=info.seq_len, global_batch=info.batch_size)
        formula = planner.plan_parallelism({0: 1}, profile)
        by_hand = (info.batch_size * info.seq_len * info.flops_per_token
                   / (info.peak_flops_per_chip * 0.6))
        out["calibration"] = entry[0] if entry else {}
        log(f"replan calibration: {json.dumps(out['calibration'])}; the "
            f"planner's formula {formula['predicted_step_s']!r} s, by hand "
            f"{by_hand!r} s ({smi})")
        if (not entry or entry[0]["samples"] < 3
                or info.peak_flops_per_chip != PEAK_BF16_FLOPS
                or entry[0]["predicted_step_s"]
                != round(formula["predicted_step_s"], 9)
                or abs(formula["predicted_step_s"] / by_hand - 1) > 1e-12):
            raise AssertionError(f"replan: calibration {calibration}, "
                                 f"formula {formula}")

        # gate 7: the ledger's replans row holds plan, migrate, rebuild
        row = [r for r in goodput.get("replans", [])
               if r["rank"] == 0 and r["generation"] == post["generation"]]
        out["ledger_row"] = row[0] if row else {}
        if not row or sorted(row[0]["phases"]) != ["migrate", "plan",
                                                   "rebuild"]:
            raise AssertionError(f"replan: ledger replans "
                                 f"{goodput.get('replans')}")

        # gate 8: both workers launched every training kernel, exactly
        # as their steps and micro batches imply
        accum = 8 // REPLAN_MICRO
        launches = {"leaver": leaver[0].get("launches"),
                    "survivor": resumed.get("launches")}
        want = {"leaver": _expected_launches(cfg, REPLAN_LEAVE_AT * accum),
                "survivor": _expected_launches(
                    cfg, (REPLAN_STEPS - stop) * accum)}
        if launches != want:
            raise AssertionError(f"replan: launches {launches}, want {want}")
        out["launches"] = {name: launches["survivor"][name]
                           + launches["leaver"][name]
                           + first.get("launches", {}).get(name, 0)
                           for name in want["survivor"]}

        # printed, not gated
        regression = [r for r in reports if r["rule"] == "plan_regression"]
        leave_line = [t for t, text in _agent_lines(errs[1])
                      if "drain complete" in text]
        t_first = min(r[0] for r in resumed["steps"].values())
        # the drain to the first resumed step by part, on the wall clock
        spawn = [t for t, text in _agent_lines(errs[0])
                 if "spawning worker (round 1," in text]
        times = resumed.get("times", {})
        marks = [("drained", leave_line[0] if leave_line else None),
                 ("stop_save_committed", first["commits"].get(stop)),
                 ("respawned", spawn[0] if spawn else None),
                 ("imported", times.get("imported")),
                 ("loop_built", times.get("loop_built")),
                 ("restored", times.get("restored")),
                 ("first_resumed_step", t_first)]
        resize_parts = {f"{a}->{b}": tb - ta for (a, ta), (b, tb)
                        in zip(marks, marks[1:])
                        if ta is not None and tb is not None}
        peaks = {}
        for rank in (0, 1):
            with open(logs[rank]) as f:
                peaks[rank] = max(
                    (json.loads(line.split("worker_allocator_peak ", 1)[1])
                     ["bytes"] for line in f
                     if "worker_allocator_peak " in line), default=0)
        out["printed"] = {
            "predicted_step_s": entry[0]["predicted_step_s"],
            "measured_step_s": entry[0]["measured_step_s"],
            "ratio": entry[0]["ratio"],
            "plan_regression": [{k: r[k] for k in ("severity", "summary")}
                                | {"windows_over": r.get("details", {})
                                   .get("windows_over")}
                                for r in regression],
            "plan_migrate_rebuild_s": out["spans"],
            "migrate_bytes": migrate[0]["attrs"].get("bytes"),
            "leaver_drained_to_first_resumed_step_s": (
                t_first - leave_line[0] if leave_line else None),
            "resize_parts_s": resize_parts,
            "shared_step_ms_median": {
                rank: stats.median(v) * 1e3 for rank, v in shared.items()},
            "resumed_step_ms_median": stats.median(
                r[3] for r in resumed["steps"].values()) * 1e3,
            "allocator_peak_bytes": peaks,
            "same_bits_both_replicas": out["same_bits_both_replicas"]}
        log(f"replan printed: {json.dumps(out['printed'])} ({smi})")
        out["phase_s"] = time.monotonic() - t_phase
        log(f"replan: the phase took {out['phase_s']:.1f} s (the agents "
            f"{out['agents_s']:.1f} s) ({smi})")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
        master.stop(grace_s=0.5)
        ctx.update(**saved)
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# models: the GPT-2 and BERT families at their published widths
# ---------------------------------------------------------------------------

# nanoGPT's config/train_gpt2.py on one GPU: batch_size 12, block_size
# 1024, gradient_accumulation_steps 5 * 8 (a global batch of 480)
GPT2_MICRO, GPT2_GLOBAL, GPT2_SEQ = 12, 480, 1024
# the BERT paper's seq-512 pretraining batch of 256 sequences, in micro
# batches of 32
BERT_MICRO, BERT_GLOBAL, BERT_SEQ = 32, 256, 512
MODELS_WARMUP, MODELS_TIMED = 2, 5
# the flash-against-reference check at full width, cut to 2 layers
MODELS_PARITY_LAYERS = 2
# the nanoGPT example under the port's agent: 6 steps saving every 3,
# then 9 from the committed step 6
EXAMPLE_BATCH, EXAMPLE_STEPS, EXAMPLE_RESUMED_STEPS = 48, 6, 9


def _model_family(name: str, layers: int = 0, attn_impl: str = "flash"):
    """(config, model class, loss, seq, micro, global batch) of GPT-2
    small or BERT-base, ``layers`` deep when given."""
    from dlrover_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import cross_entropy_loss

    if name == "gpt2":
        cfg = GPTConfig(attn_impl=attn_impl,
                        **({"n_layer": layers} if layers else {}))
        return (cfg, GPT, cross_entropy_loss, GPT2_SEQ, GPT2_MICRO,
                GPT2_GLOBAL)
    cfg = BertConfig.base(attn_impl=attn_impl,
                          **({"num_layers": layers} if layers else {}))
    return cfg, Bert, mlm_loss, BERT_SEQ, BERT_MICRO, BERT_GLOBAL


def _train_family(name: str, profile_out: str) -> tuple:
    """GPT-2 small or BERT-base at full width through ElasticTrainLoop,
    2 warm-up and 5 timed steps: (result, launches). BERT scores each
    token against itself (dense MLM targets)."""
    from dlrover_tpu_torch.trainer.elastic_loop import model_flops_per_token

    cfg, model_cls, loss_fn, seq, micro, global_batch = _model_family(name)
    steps = MODELS_WARMUP + MODELS_TIMED
    accum = global_batch // micro
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, launches = _train(cfg, global_batch, steps, micro,
                            profile_out=profile_out, model_cls=model_cls,
                            loss_fn=loss_fn, seq=seq,
                            same_targets=name == "bert")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in hist:
        log(f"  {name} step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != steps:
        raise AssertionError(f"{name}: ran {len(hist)} steps")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in hist):
        raise AssertionError(f"{name}: non-finite loss or grad norm")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"{name}: first loss {hist[0]['loss']} is not "
                             f"near ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.3f}")
    timed = hist[MODELS_WARMUP:]
    if not timed[-1]["loss"] < timed[0]["loss"]:
        raise AssertionError(f"{name}: the loss did not fall over the "
                             f"timed steps: {[r['loss'] for r in timed]}")
    want = _expected_launches(cfg, accum * steps)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             f"({steps} steps of {accum} micro-batches)")
    params = sum(p.numel() for p in model_cls(cfg, device="meta")
                 .parameters())
    flops = model_flops_per_token(cfg, params, seq)
    # the attention term counted in full (obs/mfu.py: 12·L·h·s a token,
    # halved when causal): GPT's config has no num_layers/hidden_size,
    # so the loop counts none; BERT's it counts as causal, half its work
    layers = getattr(cfg, "num_layers", 0) or cfg.n_layer
    width = getattr(cfg, "hidden_size", 0) or cfg.n_embd
    flops_full = 6.0 * params + (6.0 if name == "gpt2" else 12.0) \
        * layers * width * seq
    step_ms = [r["step_time_s"] * 1e3 for r in timed]
    mfu = statistics.mean(r["mfu"] for r in timed)
    tokens_per_s = global_batch * seq / (statistics.mean(step_ms) / 1e3)
    result = {"params": params, "micro_batch": micro,
              "global_batch": global_batch, "seq": seq,
              "step_median_ms": statistics.median(step_ms),
              "step_min_ms": min(step_ms), "step_max_ms": max(step_ms),
              "step_mean_ms": statistics.mean(step_ms),
              "tokens_per_s": tokens_per_s, "flops_per_token": flops,
              "mfu": mfu, "flops_per_token_full": flops_full,
              "mfu_full": mfu * flops_full / flops,
              "peak_mem_gb": peak_gb,
              "losses": [r["loss"] for r in hist],
              "launches_per_step": {n: c / steps
                                    for n, c in launches.items()}}
    log(f"models {name}: {json.dumps(result)}")
    return result, launches


def _family_parity(name: str) -> None:
    """Reduced depth at full width: the same init trained 3 steps with
    attn_impl="flash" and "reference", one step's gradients of each;
    held to the parity phase's limits (``_compare_runs``)."""
    losses, grad_norms, grads = {}, {}, {}
    same = name == "bert"
    for attn in ("flash", "reference"):
        cfg, model_cls, loss_fn, seq, micro, _ = _model_family(
            name, MODELS_PARITY_LAYERS, attn)
        g = torch.Generator(device="cuda").manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (micro, seq), generator=g,
                               device="cuda")
        targets = tokens if same else torch.randint(
            0, cfg.vocab_size, (micro, seq), generator=g, device="cuda")
        grads[attn] = _one_step_grads(cfg, tokens, targets, model_cls,
                                      loss_fn)
        reset_counts()
        hist, launches = _train(cfg, micro, 3, micro, model_cls=model_cls,
                                loss_fn=loss_fn, seq=seq, same_targets=same)
        losses[attn] = [r["loss"] for r in hist]
        grad_norms[attn] = [r["grad_norm"] for r in hist]
        want = _expected_launches(cfg, len(hist))
        if launches != want:
            raise AssertionError(f"{name} {attn} parity run launches "
                                 f"{launches}, want {want}")
    block = "block" if name == "gpt2" else "layer"
    _compare_runs(f"{name} attention, {MODELS_PARITY_LAYERS} layers",
                  "flash", "reference", losses, grad_norms, grads,
                  [f"{block}_{i}.qkv.kernel"
                   for i in range(MODELS_PARITY_LAYERS)])
    del grads
    torch.cuda.empty_cache()


# the nanoGPT example at GPT-2 small: seq 1024, global batch 48
NANOGPT_WORKER = ["dlrover_tpu_torch/examples/nanogpt_train.py", "--config",
                  "gpt2", "--seq", str(GPT2_SEQ), "--global-batch",
                  str(EXAMPLE_BATCH)]


def _example_run(repo: str, tmp: str, steps: int, tag: str,
                 agent_tmp: str, worker=None, what: str = "models",
                 run_args: tuple = (), agent_log: list = None) -> list:
    """``python -m dlrover_tpu_torch.run --standalone`` (with
    ``run_args``) around an example worker (``worker``: its script and
    arguments, NANOGPT_WORKER by default) for ``steps`` steps with a save
    every 3 into ``tmp``, the agent's work directory (its peer cache) in
    ``agent_tmp``; returns the worker's log lines (and extends
    ``agent_log`` with the agent's) and prints the agent's marks. Fails
    unless the agent exits 0."""
    import os
    import re

    ckpt, log_file = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
           "--monitor-interval", "1", *run_args, *(worker or NANOGPT_WORKER),
           "--steps", str(steps), "--save-interval", "3", "--ckpt-dir", ckpt,
           "--log-file", log_file]
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=agent_tmp)
    t0 = time.time()
    err = os.path.join(tmp, f"{tag}.err")
    with open(os.path.join(tmp, f"{tag}.out"), "w") as fo, \
            open(err, "w") as fe:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=fo,
                                stderr=fe)
        try:
            rc = proc.wait(timeout=EXAMPLE_WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    elapsed = time.time() - t0
    # the first of each mark, the last commit
    marks = {}
    agent_lines = _agent_lines(err)
    if agent_log is not None:
        agent_log.extend(agent_lines)
    for t, text in agent_lines:
        for key, pattern in (("spawned", r"^spawning worker"),
                             ("loop built", r"^elastic loop: device"),
                             ("first step", r"^step \d+ loss"),
                             ("last commit",
                              r"^flash checkpoint: step \d+ committed"),
                             ("worker exit", r"^worker finished")):
            if re.search(pattern, text) and (key == "last commit"
                                             or key not in marks):
                marks[key] = round(t - t0, 2)
    with open(err) as f:
        err_tail = f.read()[-3000:]
    lines = []
    if os.path.exists(log_file):
        with open(log_file) as f:
            lines = f.read().splitlines()
    log(f"{what} example {tag}: exit {rc} in {elapsed:.1f} s, marks (s "
        f"from the start) {json.dumps(marks)}; log {lines}")
    if rc != 0:
        raise AssertionError(f"{what} example {tag} exited {rc}:\n"
                             f"{err_tail}")
    return lines


def _network_check_rounds(agent_lines: list, smi: str) -> dict:
    """The network check in an agent's log: two rounds, both normal,
    before the worker was spawned; each round's timed window and the
    probe's time, and the check's whole time."""
    import re

    rounds, probe_s, total_s = [], [], None
    t_rounds, t_spawn = [], None
    for t, text in agent_lines:
        m = re.match(r"network check round (\d+): normal=(\w+) "
                     r"elapsed=([\d.]+)s", text)
        if m:
            rounds.append({"round": int(m.group(1)),
                           "normal": m.group(2) == "True",
                           "elapsed_s": float(m.group(3))})
            t_rounds.append(t)
        m = re.match(r"network check: the probe's round .* took ([\d.]+) s",
                     text)
        if m:
            probe_s.append(float(m.group(1)))
        m = re.match(r"network check: \d+ rounds in ([\d.]+) s", text)
        if m:
            total_s = float(m.group(1))
        if t_spawn is None and text.startswith("spawning worker"):
            t_spawn = t
    out = {"rounds": rounds, "probe_round_s": probe_s,
           "check_s": total_s}
    log(f"models network check: {json.dumps(out)} ({smi})")
    if ([r["round"] for r in rounds] != [0, 1]
            or not all(r["normal"] for r in rounds)):
        raise AssertionError(f"the network check's rounds: {rounds}")
    if t_spawn is None or max(t_rounds) > t_spawn:
        raise AssertionError("the worker was not spawned after the network "
                             "check's rounds")
    return out


def _example_against_direct(agent_lines: list, smi: str) -> dict:
    """The example's steps, as its loop logged them in both launches,
    against the same steps built directly in this process (GPT-2 small,
    the example's batch, seq, optimizer and data): the same losses and
    grad norms, bit for bit."""
    import re

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    logged = {}
    for _, text in agent_lines:
        m = re.match(r"step (\d+) loss (\S+) grad_norm (\S+) ", text)
        if m:
            logged[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    reset_counts()
    hist, _ = _train(GPTConfig(), EXAMPLE_BATCH, EXAMPLE_RESUMED_STEPS, 8,
                     model_cls=GPT, seq=GPT2_SEQ)
    direct = {r["step"]: (r["loss"], r["grad_norm"]) for r in hist}
    same = {n: logged.get(n) == direct[n] for n in direct}
    log(f"models example against the direct build: {json.dumps(same)} "
        f"({smi})")
    if sorted(logged) != sorted(direct) or not all(same.values()):
        raise AssertionError(f"the example's steps {logged}, built directly "
                             f"{direct}")
    torch.cuda.empty_cache()
    return same


def phase_models(smi: str, profile: str = "") -> dict:
    """GPT-2 small and BERT-base train at their published widths through
    the port's loop with the flash kernels at head dim 64 (causal and
    bidirectional); flash against reference at 2 layers; the nanoGPT
    example under the port's agent resumes from its checkpoint."""
    import os
    import shutil
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    out = {"launches": {}}
    for name in ("gpt2", "bert"):
        result, launches = _train_family(
            name, f"{profile}.{name}" if profile else "")
        out[name] = result
        for kernel, count in launches.items():
            out["launches"][kernel] = (out["launches"].get(kernel, 0)
                                       + count)
        log(f"models {name} on {smi}: step median "
            f"{result['step_median_ms']:.1f} ms (min "
            f"{result['step_min_ms']:.1f}, max {result['step_max_ms']:.1f}),"
            f" {result['tokens_per_s']:.0f} tokens/s, MFU "
            f"{result['mfu']:.4f} as the loop reports it, "
            f"{result['mfu_full']:.4f} with the attention term in full, "
            f"allocator peak {result['peak_mem_gb']:.2f} GiB")
        torch.cuda.empty_cache()
    for name in ("gpt2", "bert"):
        _family_parity(name)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    agent_tmps = []
    try:
        # each agent's work directory (its peer cache of two stages) on
        # /dev/shm when that holds them, as the standalone phase's
        state_bytes = 3 * 4 * out["gpt2"]["params"]
        agent_tmps = [peer_root(state_bytes, tmp, smi, "models example")
                      for _ in range(2)]
        # the first launch runs the network check's probe on the card
        # before its worker
        agent_first, agent_second = [], []
        first = _example_run(repo, tmp, EXAMPLE_STEPS, "first",
                             agent_tmps[0], run_args=("--network-check",),
                             agent_log=agent_first)
        if not any(line.startswith(f"nanogpt: done step={EXAMPLE_STEPS} ")
                   for line in first):
            raise AssertionError(f"the example did not finish step "
                                 f"{EXAMPLE_STEPS}: {first}")
        out["network_check"] = _network_check_rounds(agent_first, smi)
        second = _example_run(repo, tmp, EXAMPLE_RESUMED_STEPS, "resumed",
                              agent_tmps[1], agent_log=agent_second)
        new = second[len(first):]
        if not any(line.startswith(f"nanogpt: start_step={EXAMPLE_STEPS} ")
                   for line in new):
            raise AssertionError(f"the example did not resume at step "
                                 f"{EXAMPLE_STEPS}: {new}")
        if not any(line.startswith(
                f"nanogpt: done step={EXAMPLE_RESUMED_STEPS} ")
                for line in new):
            raise AssertionError(f"the resumed example did not finish "
                                 f"step {EXAMPLE_RESUMED_STEPS}: {new}")
        out["example_bits"] = _example_against_direct(
            agent_first + agent_second, smi)
    finally:
        for path in agent_tmps + [tmp]:
            shutil.rmtree(path, ignore_errors=True)
    log(f"models: phase {time.monotonic() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# llama7b: the streaming step, rematerialization, the per-leaf optimizer
# and the prefetch tuner at Llama-7B
# ---------------------------------------------------------------------------

# the JAX headline's lean branch for a card over 60 GB (bench.py:386-411):
# Llama-7B, micro 2, seq 2048, optax.scale_by_factored_rms chained with
# scale(-3e-4)
LLAMA7B_MICRO, LLAMA7B_SEQ, LLAMA7B_LR = 2, 2048, 3e-4
LLAMA7B_WARMUP, LLAMA7B_TIMED = 2, 5
# the streaming step against the dense one at full width, cut to 2 layers:
# one step each from one init on one batch. The forward is the same
# kernels on the same inputs; the head's loss is summed over 512-token
# chunks in one and taken whole in the other, so the loss and the head's
# products differ in f32 and bf16 rounding and so does every gradient
# below them. Held: the losses within 1e-3, the grad norms within the
# parity phase's 1e-2 relative, and each parameter's update (new − old,
# a factored-RMS step of size ≈ lr) within 2^-5 relative L2
STREAM_LOSS_TOL = 1e-3
STREAM_UPDATE_TOL = 2.0 ** -5
LLAMA7B_PARITY_LAYERS = 2
# the streaming trainer under the loop: full width cut to 4 layers, 6
# uninterrupted steps against 3 saving at 3, then 3 more from the restore
LLAMA7B_LOOP_LAYERS, LLAMA7B_LOOP_STEPS, LLAMA7B_LOOP_SAVE = 4, 6, 3
# Llama-1B under remat beside the llama1b phase's run: the policies
REMAT_POLICIES = ("nothing_saveable", "dots_saveable")


def llama7b_config(layers: int = 0, **kw):
    """``LlamaConfig.llama_7b`` in the JAX headline configuration (flash
    attention, fused norm, gather embedding, f32 weights, bf16
    activations), ``layers`` deep when given."""
    import dataclasses

    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama_7b(max_seq_len=LLAMA7B_SEQ, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather", **kw)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _factored_rms():
    """(the per-leaf transform, the dense optimizer factory over it)."""
    from dlrover_tpu_torch.optim import LeafOptimizer, factored_rms

    transform = factored_rms(LLAMA7B_LR)
    return transform, functools.partial(LeafOptimizer, transform=transform)


def _streaming_trainer(cfg):
    from dlrover_tpu_torch.trainer.streaming import build_streaming_trainer

    return build_streaming_trainer(cfg, _factored_rms()[0], LLAMA7B_MICRO)


def _stream_parity() -> dict:
    """(a) One streaming and one dense step at full width, 2 layers, from
    one init on one batch: losses, grad norms and every parameter's
    update within the STREAM_* limits; each step's launches as
    predicted."""
    import numpy as np

    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = llama7b_config(LLAMA7B_PARITY_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(7)
    tokens, targets = (torch.randint(0, cfg.vocab_size,
                                     (1, LLAMA7B_MICRO, LLAMA7B_SEQ),
                                     generator=g, device="cuda")
                       for _ in range(2))
    trainers = {
        "streaming": _streaming_trainer(cfg),
        "dense": build_trainer(
            functools.partial(Llama, cfg), _factored_rms()[1], None,
            np.zeros((LLAMA7B_MICRO, LLAMA7B_SEQ)), cross_entropy_loss,
            micro_batch=LLAMA7B_MICRO)}
    runs = {}
    for name, trainer in trainers.items():
        state = trainer.init(0)
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        reset_counts()
        state, metrics = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        launches = read_counts()
        want = _expected_launches(cfg, 1, recompute=name == "streaming")
        if launches != want:
            raise AssertionError(f"llama7b parity {name} launches "
                                 f"{launches}, want {want}")
        runs[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      {n: (p.detach() - before[n]).float()
                       for n, p in state.model.named_parameters()})
        del state, before
        _free_memory()
    (s_loss, s_norm, s_upd), (d_loss, d_norm, d_upd) = (
        runs["streaming"], runs["dense"])
    errs = {n: _rel_l2(s_upd[n], d_upd[n]) for n in d_upd}
    worst = sorted(errs, key=errs.get, reverse=True)
    out = {"loss": [s_loss, d_loss], "grad_norm": [s_norm, d_norm],
           "loss_diff": abs(s_loss - d_loss),
           "grad_norm_rel_diff": abs(s_norm - d_norm) / d_norm,
           "worst_update_rel_l2": {n: errs[n] for n in worst[:4]}}
    log(f"llama7b parity (streaming vs dense, {LLAMA7B_PARITY_LAYERS} "
        f"layers): {json.dumps(out)} (limits: loss {STREAM_LOSS_TOL}, grad "
        f"norm {PARITY_GRAD_NORM_TOL}, update {STREAM_UPDATE_TOL})")
    if not out["loss_diff"] <= STREAM_LOSS_TOL:
        raise AssertionError("llama7b parity: losses disagree")
    if not out["grad_norm_rel_diff"] <= PARITY_GRAD_NORM_TOL:
        raise AssertionError("llama7b parity: grad norms disagree")
    if not errs[worst[0]] <= STREAM_UPDATE_TOL:
        raise AssertionError(f"llama7b parity: updates disagree: {worst[0]} "
                             f"{errs[worst[0]]}")
    del runs, s_upd, d_upd
    _free_memory()
    return out


def _llama7b_run(kind: str, smi: str, profile_out: str = "") -> tuple:
    """(b) the streaming step or (c) the dense step under
    remat="nothing_saveable", at Llama-7B's full width and depth through
    ElasticTrainLoop, 2 warm-up + 5 timed steps: (result, launches); with
    ``profile_out``, one more step profiled after them."""
    streaming = kind == "streaming"
    cfg = (llama7b_config() if streaming else
           llama7b_config(remat=True, remat_policy="nothing_saveable"))
    steps = LLAMA7B_WARMUP + LLAMA7B_TIMED
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, launches = _train(
        cfg, LLAMA7B_MICRO, steps, LLAMA7B_MICRO, profile_out=profile_out,
        optimizer_factory=_factored_rms()[1],
        trainer=_streaming_trainer(cfg) if streaming else None)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in hist:
        log(f"  llama7b {kind} step {r['step']}: loss {r['loss']:.4f} "
            f"grad_norm {r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != steps:
        raise AssertionError(f"llama7b {kind}: ran {len(hist)} steps")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in hist):
        raise AssertionError(f"llama7b {kind}: non-finite loss or grad norm")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"llama7b {kind}: first loss {hist[0]['loss']} "
                             f"is not near ln(vocab)")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"llama7b {kind}: the loss did not fall: "
                             f"{[r['loss'] for r in hist]}")
    want = _expected_launches(cfg, steps, recompute=streaming)
    if launches != want:
        raise AssertionError(f"llama7b {kind}: launches {launches}, want "
                             f"{want} ({steps} steps)")
    timed = hist[LLAMA7B_WARMUP:]
    step_ms = [r["step_time_s"] * 1e3 for r in timed]
    result = {"kind": kind, "params": cfg.param_count(),
              "layers": cfg.num_layers, "micro_batch": LLAMA7B_MICRO,
              "seq": LLAMA7B_SEQ, "remat": cfg.remat,
              "step_median_ms": statistics.median(step_ms),
              "step_min_ms": min(step_ms), "step_max_ms": max(step_ms),
              "tokens_per_s": LLAMA7B_MICRO * LLAMA7B_SEQ
              / (statistics.mean(step_ms) / 1e3),
              "mfu": statistics.mean(r["mfu"] for r in timed),
              "peak_mem_gb": peak_gb, "losses": [r["loss"] for r in hist],
              "launches_per_step": {n: c / steps
                                    for n, c in launches.items()},
              "seconds": time.monotonic() - t0}
    log(f"llama7b {kind}: {json.dumps(result)}")
    log(f"llama7b {kind} on {smi}: step median "
        f"{result['step_median_ms']:.1f} ms (min {result['step_min_ms']:.1f},"
        f" max {result['step_max_ms']:.1f}), {result['tokens_per_s']:.0f} "
        f"tokens/s, MFU {result['mfu']:.4f} as the loop reports it, "
        f"allocator peak {peak_gb:.2f} GiB")
    _free_memory()
    return result, launches


def _streaming_loop_resume(smi: str) -> dict:
    """(d) the streaming trainer through ElasticTrainLoop(trainer=...) at
    full width, 4 layers, under a JobMaster in this process (a step
    report a step, so the prefetch tuner observes every window), batches
    from prefetch_to_device at the tuner's depth: 6 uninterrupted steps,
    against 3 saving at 3 and 3 more in a rebuilt loop from the restore;
    the same losses and final parameters, bit for bit."""
    import shutil
    import tempfile

    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.data.prefetch import prefetch_to_device
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    cfg = llama7b_config(LLAMA7B_LOOP_LAYERS)
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, timeout_s=30.0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_7b_")
    corpus = synthetic_corpus(cfg.vocab_size)
    out = {"launches": {}}

    def run(tag: str, ckpt: str, steps: int):
        loop = ElasticTrainLoop(
            None, None, None,
            TrainLoopConfig(global_batch=LLAMA7B_MICRO, seq_len=LLAMA7B_SEQ,
                            max_micro_per_replica=LLAMA7B_MICRO,
                            max_steps=steps, checkpoint_dir=ckpt,
                            save_interval_steps=LLAMA7B_LOOP_SAVE,
                            report_interval_steps=1),
            master_client=client, trainer=_streaming_trainer(cfg))
        tuner = loop.prefetch_tuner
        if tuner is None:
            raise AssertionError("the loop built no prefetch tuner")
        # each report window's (data-wait share, depth) as the tuner
        # takes it
        windows, observe = [], tuner.observe

        def logged(wait):
            depth = observe(wait)
            windows.append((round(wait, 4), depth))
            return depth

        tuner.observe = logged
        sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
        state, start = loop.restore_or_init(0, sampler)
        reset_counts()
        state, metrics = loop.run(
            state, prefetch_to_device(
                batches(corpus, sampler, LLAMA7B_MICRO, LLAMA7B_SEQ),
                depth=tuner.depth_fn),
            start_step=start, sampler=sampler)
        launches = read_counts()
        loop.close()
        hist = metrics["history"]
        want = _expected_launches(cfg, len(hist), recompute=True)
        if len(hist) != steps or launches != want:
            raise AssertionError(f"llama7b loop {tag}: {len(hist)} steps, "
                                 f"launches {launches}, want {want}")
        gauge = [float(line.split()[1]) for line in
                 obs.get_registry().render().splitlines()
                 if line.startswith("dlrover_tpu_prefetch_depth ")]
        if gauge != [tuner.depth] or len(windows) != steps:
            raise AssertionError(f"llama7b loop {tag}: depth gauge {gauge}, "
                                 f"tuner depth {tuner.depth}, "
                                 f"{len(windows)} windows observed")
        wait = loop.timeline.window_stats(len(hist)).get(
            "data_wait_fraction", -1.0)
        log(f"llama7b loop {tag}: start {start} ({loop.last_restore_source})"
            f", losses {[r['loss'] for r in hist]}, prefetch depth gauge "
            f"{gauge}; (data-wait share, depth) a report window {windows};"
            f" data-wait share {wait:.4f} over the run's {len(hist)} steps "
            f"(the first pull builds the sampler's order), step median "
            f"{statistics.median(r['step_time_s'] for r in hist) * 1e3:.1f} "
            f"ms ({smi})")
        out["launches"][tag] = launches
        out[tag] = {"start": start, "source": loop.last_restore_source,
                    "losses": [r["loss"] for r in hist],
                    "prefetch_depth": tuner.depth, "windows": windows,
                    "data_wait_fraction": wait}
        return state

    try:
        t0 = time.monotonic()
        whole = run("uninterrupted", "", LLAMA7B_LOOP_STEPS)
        run("first", tmp, LLAMA7B_LOOP_SAVE)
        resumed = run("resumed", tmp, LLAMA7B_LOOP_STEPS - LLAMA7B_LOOP_SAVE)
        if out["resumed"]["start"] != LLAMA7B_LOOP_SAVE or \
                out["resumed"]["source"] != "checkpoint":
            raise AssertionError(f"llama7b loop: resumed at "
                                 f"{out['resumed']['start']} from "
                                 f"{out['resumed']['source']}")
        if out["first"]["losses"] + out["resumed"]["losses"] != \
                out["uninterrupted"]["losses"]:
            raise AssertionError("llama7b loop: the resumed losses are not "
                                 "the uninterrupted run's bits")
        differ = [n for (n, p), q in zip(whole.model.named_parameters(),
                                         resumed.model.parameters())
                  if not torch.equal(p, q)]
        if differ:
            raise AssertionError(f"llama7b loop: parameters differ from the "
                                 f"uninterrupted run's: {differ[:4]}")
        out["seconds"] = time.monotonic() - t0
        log(f"llama7b loop: the resume trained the uninterrupted run's bits "
            f"(losses and {sum(1 for _ in whole.model.parameters())} "
            f"parameters) in {out['seconds']:.1f} s")
    finally:
        client.close()
        master.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        _free_memory()
    return out


def _remat_llama1b(smi: str, llama1b: dict) -> dict:
    """(e) the llama1b phase's run with remat under each of
    REMAT_POLICIES: peak and step beside the no-remat run's of this call
    (run here when the llama1b phase did not run)."""
    import dataclasses

    from dlrover_tpu_torch.models.llama import LlamaConfig

    if not llama1b:
        _, llama1b = phase_llama1b()
        _free_memory()
    base = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                                norm_impl="fused", embed_impl="gather")
    out = {"none": {"peak_mem_gb": llama1b["peak_mem_gb"],
                    "step_median_ms": llama1b["step_median_ms"]}}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        hist, launches = _train(cfg, global_batch=8, steps=7, max_micro=8)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        want = _expected_launches(cfg, len(hist))
        if launches != want:
            raise AssertionError(f"llama1b remat {policy}: launches "
                                 f"{launches}, want {want}")
        if not all(math.isfinite(r["loss"]) for r in hist):
            raise AssertionError(f"llama1b remat {policy}: non-finite loss")
        step_ms = statistics.median(r["step_time_s"] for r in hist[2:]) * 1e3
        out[policy] = {"peak_mem_gb": peak_gb, "step_median_ms": step_ms,
                       "losses": [r["loss"] for r in hist]}
        log(f"llama1b remat {policy} on {smi}: peak {peak_gb:.2f} GiB "
            f"(no remat {out['none']['peak_mem_gb']:.2f}), step median "
            f"{step_ms:.1f} ms (no remat "
            f"{out['none']['step_median_ms']:.1f})")
        _free_memory()
    if not out["nothing_saveable"]["peak_mem_gb"] < out["none"]["peak_mem_gb"]:
        raise AssertionError("llama1b: remat did not lower the peak")
    return out


def phase_llama7b(smi: str, llama1b: dict, profile: str = "") -> dict:
    """Llama-7B on one card: (a) streaming against dense at 2 layers, (b)
    the streaming step and (c) the dense step under remat at full depth
    (with ``profile``, one more step of each profiled into
    ``<profile>.llama7b_<kind>``), (d) the streaming trainer's save and
    resume under the loop with the prefetch tuner, (e) remat on
    Llama-1B."""
    t0 = time.monotonic()
    _free_memory()
    out = {"seconds": {}}
    mark = time.monotonic()
    out["parity"] = _stream_parity()
    out["seconds"]["parity"] = time.monotonic() - mark
    out["launches"] = {}
    for kind in ("streaming", "dense_remat"):
        mark = time.monotonic()
        out[kind], out["launches"][kind] = _llama7b_run(
            kind, smi, f"{profile}.llama7b_{kind}" if profile else "")
        out["seconds"][kind] = time.monotonic() - mark
    mark = time.monotonic()
    out["loop"] = _streaming_loop_resume(smi)
    out["seconds"]["loop"] = time.monotonic() - mark
    mark = time.monotonic()
    out["remat_llama1b"] = _remat_llama1b(smi, llama1b)
    out["seconds"]["remat_llama1b"] = time.monotonic() - mark
    out["seconds"]["phase"] = time.monotonic() - t0
    log(f"llama7b: seconds by part {json.dumps(out['seconds'])}")
    return out

# ---------------------------------------------------------------------------
# moe: the Mixtral-style family at Mixtral-8x7B's widths
# ---------------------------------------------------------------------------

# Mixtral-8x7B's published widths (Mistral AI, mistralai/Mixtral-8x7B-v0.1,
# config.json): hidden 4096, expert intermediate 14336, 32 heads of 128 and
# 8 KV heads, 8 experts with top-2 routing, vocabulary 32000, rope_theta
# 1e6, rms_norm_eps 1e-5, 32 layers. The repo's expert MLP is wi, gelu, wo
# (not Mixtral's SwiGLU), kept as the JAX package has it. Cut to 4 layers
# so that the f32 weights and gradients (33.5 GB) fit one card.
MIXTRAL_WIDTHS = dict(vocab_size=32000, hidden_size=4096,
                      intermediate_size=14336, num_heads=32, num_kv_heads=8,
                      num_experts=8, top_k=2, rope_theta=1e6,
                      rms_norm_eps=1e-5)
MIXTRAL_PUBLISHED_LAYERS = 32
MOE_LAYERS = 4
# the JAX example's optimizer (optax.adafactor) and learning rate; micro
# 4, global 8 (2 micro-steps), seq 2048
MOE_SEQ, MOE_MICRO, MOE_GLOBAL, MOE_LR = 2048, 4, 8, 3e-4
MOE_WARMUP, MOE_TIMED = 2, 5
# flash against reference attention at full width, cut to 2 layers
MOE_PARITY_LAYERS = 2
# the MoE example under the port's agent at its defaults: 6 steps saving
# every 3, then 9 from the committed step 6
MOE_WORKER = ["dlrover_tpu_torch/examples/moe_train.py"]


def mixtral_config(layers: int = MOE_LAYERS, attn_impl: str = "flash"):
    """LlamaMoE at Mixtral-8x7B's widths, ``layers`` deep, in the JAX
    headline configuration (flash attention, fused norm, gather
    embedding, f32 weights, bf16 activations)."""
    from dlrover_tpu_torch.models.llama_moe import LlamaMoEConfig

    return LlamaMoEConfig(num_layers=layers, max_seq_len=MOE_SEQ,
                          attn_impl=attn_impl, norm_impl="fused",
                          embed_impl="gather", **MIXTRAL_WIDTHS)


def _llama_moe(cfg, **kw):
    """LlamaMoE in training routing (the example's deterministic=False)."""
    from dlrover_tpu_torch.models.llama_moe import LlamaMoE

    return LlamaMoE(cfg, deterministic=False, **kw)


def _adafactor(params):
    # optax.adafactor(3e-4)
    from dlrover_tpu_torch.optim import LeafOptimizer, adafactor

    return LeafOptimizer(params, adafactor(MOE_LR))


def moe_flops_done(cfg, seq: int) -> float:
    """The products a token costs in a training step as the code runs
    them (forward ×3 for forward and backward): the attention
    projections, the causal scores and values (mean (s + 1)/2 keys a
    query), the router, the dispatch and combine einsums (E·C slots a
    group of s tokens) and the experts at every slot (filled or not, E·C
    of them), and the head."""
    from dlrover_tpu_torch.parallel.moe import _capacity

    h, m, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    kv = cfg.num_kv_heads * cfg.head_dim
    slots = min(_capacity(seq, e, cfg.capacity_factor, 4), seq) * e
    per_layer = (2 * (2 * h * h + 2 * h * kv)
                 + 4 * h * (seq + 1) / 2
                 + 2 * h * e
                 + 2 * 2 * slots * h
                 + slots / seq * 4 * h * m)
    return 3.0 * (cfg.num_layers * per_layer + 2 * h * cfg.vocab_size)


def _routing_stats(model, tokens) -> dict:
    """One forward of ``model`` on ``tokens``, each MoE layer's routing
    read back by a hook: the aux loss (the model's sum, weighted), the
    share of the top-k assignments dropped at capacity and each expert's
    filled slots (ROADMAP Queue C13)."""
    from dlrover_tpu_torch.parallel.moe import _capacity, top_k_gating

    cfg = model.config
    loads, capacities, dropped, assigned = [], set(), 0, 0

    def hook(module, args, _out):
        x = args[0].reshape(-1, *args[0].shape[-2:]).float()
        capacity = min(_capacity(x.shape[1], cfg.num_experts,
                                 cfg.capacity_factor, 4), x.shape[1])
        dispatch, _, _ = top_k_gating(x @ module.router.float(),
                                      cfg.top_k, capacity)
        load = dispatch.sum(dim=(0, 1, 3))
        loads.append([int(v) for v in load.tolist()])
        capacities.add(capacity)
        nonlocal dropped, assigned
        assigned += x.shape[0] * x.shape[1] * cfg.top_k
        dropped += x.shape[0] * x.shape[1] * cfg.top_k - int(load.sum())

    handles = [getattr(model, f"layer_{i}").moe.register_forward_hook(hook)
               for i in range(cfg.num_layers)]
    try:
        with torch.no_grad():
            _, aux = model(tokens, with_losses=True)
    finally:
        for handle in handles:
            handle.remove()
    return {"aux_loss": aux.item(), "dropped_share": dropped / assigned,
            "capacity": sorted(capacities), "expert_load_by_layer": loads}


def _moe_train(smi: str, profile_out: str) -> tuple:
    """(a) LlamaMoE at Mixtral-8x7B's widths, 4 layers, through
    ElasticTrainLoop under Adafactor, 2 warm-up + 5 timed steps:
    (result, launches)."""
    from dlrover_tpu_torch.trainer.elastic_loop import model_flops_per_token

    cfg = mixtral_config()
    steps = MOE_WARMUP + MOE_TIMED
    accum = MOE_GLOBAL // MOE_MICRO
    # the routing of one micro-batch of uniform tokens, by the seed-0 init
    # the run starts from and by the trained model
    tokens = torch.randint(0, cfg.vocab_size, (MOE_MICRO, MOE_SEQ),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(9))
    routing = {"init": _routing_stats(_llama_moe(cfg, seed=0), tokens)}
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, launches = _train(
        cfg, MOE_GLOBAL, steps, MOE_MICRO, profile_out=profile_out,
        model_cls=_llama_moe, optimizer_factory=_adafactor,
        after=lambda state, _: routing.update(
            trained=_routing_stats(state.model, tokens)))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in hist:
        log(f"  moe step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != steps:
        raise AssertionError(f"moe: ran {len(hist)} steps")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in hist):
        raise AssertionError("moe: non-finite loss or grad norm")
    timed = hist[MOE_WARMUP:]
    if not timed[-1]["loss"] < timed[0]["loss"]:
        raise AssertionError(f"moe: the loss did not fall over the timed "
                             f"steps: {[r['loss'] for r in timed]}")
    want = _expected_launches(cfg, accum * steps)
    if launches != want:
        raise AssertionError(f"moe: launches {launches}, want {want} "
                             f"({steps} steps of {accum} micro-batches)")
    params = cfg.param_count()
    step_ms = [r["step_time_s"] * 1e3 for r in timed]
    tokens_per_s = MOE_GLOBAL * MOE_SEQ / (statistics.mean(step_ms) / 1e3)
    done = moe_flops_done(cfg, MOE_SEQ)
    result = {"params": params, "active_params": cfg.active_param_count(),
              "layers": cfg.num_layers, "micro_batch": MOE_MICRO,
              "global_batch": MOE_GLOBAL, "seq": MOE_SEQ,
              "step_median_ms": statistics.median(step_ms),
              "step_min_ms": min(step_ms), "step_max_ms": max(step_ms),
              "step_mean_ms": statistics.mean(step_ms),
              "tokens_per_s": tokens_per_s,
              "flops_per_token_loop": model_flops_per_token(cfg, params,
                                                            MOE_SEQ),
              "mfu": statistics.mean(r["mfu"] for r in timed),
              "flops_per_token_done": done,
              "mfu_done": done * tokens_per_s / PEAK_BF16_FLOPS,
              "peak_mem_gb": peak_gb,
              "losses": [r["loss"] for r in hist],
              "launches_per_step": {n: c / steps
                                    for n, c in launches.items()},
              "routing": routing}
    log(f"moe train: {json.dumps(result)}")
    log(f"moe on {smi}: step median {result['step_median_ms']:.1f} ms (min "
        f"{result['step_min_ms']:.1f}, max {result['step_max_ms']:.1f}), "
        f"{tokens_per_s:.0f} tokens/s, MFU {result['mfu']:.4f} as the loop "
        f"reports it (every expert counted, ROADMAP C12), "
        f"{result['mfu_done']:.4f} over the products done "
        f"({done / 1e9:.2f} GFLOP a token), allocator peak {peak_gb:.2f} "
        f"GiB; " + "; ".join(
            f"{when}: aux loss {r['aux_loss']:.5f}, top-{cfg.top_k} "
            f"assignments dropped {r['dropped_share']:.1%} at capacity "
            f"{r['capacity']} (ROADMAP C13), per-expert load by layer "
            f"{r['expert_load_by_layer']}" for when, r in routing.items()))
    _free_memory()
    return result, launches


def _moe_parity_tokens(vocab: int, micro: int, seq: int,
                       device: str = "cuda") -> tuple:
    """The tokens and targets the MoE parity's one-step gradients take
    (drawn on ``device`` from seed 5)."""
    g = torch.Generator(device=device).manual_seed(5)
    return tuple(torch.randint(0, vocab, (micro, seq), generator=g,
                               device=device) for _ in range(2))


@contextlib.contextmanager
def _pinned_routing(record=None, replay=None):
    """Each MoE layer's routing recorded (its dispatch masks appended to
    ``record``, in call order) or replayed (``replay``'s masks, in call
    order, with the combine weights from this run's own router
    probabilities at the replayed slots, which is what routing computes
    for those slots): two runs that differ in a path before the router
    then take the same discrete decisions."""
    from dlrover_tpu_torch.parallel import moe

    route = moe.top_k_gating
    masks = iter(replay or ())

    def gating(logits, top_k, capacity):
        dispatch, combine, aux = route(logits, top_k, capacity)
        if record is not None:
            record.append(dispatch)
        if replay is not None:
            dispatch = next(masks)
            combine = dispatch * torch.softmax(logits.float(), -1)[..., None]
            combine = combine / combine.sum(dim=(2, 3), keepdim=True
                                            ).clamp(min=1e-9)
        return dispatch, combine, aux

    moe.top_k_gating = gating
    try:
        yield
    finally:
        moe.top_k_gating = route


def _moe_parity() -> dict:
    """(b) The model at full width, 2 layers, from one init, with
    attn_impl="flash" and "reference": 3 training steps each (losses and
    grad norms within the parity phase's limits) and one step's
    gradients. Routing is discrete: a bf16 rounding in attention's output
    can move a token whose top experts nearly tie to another expert, and
    every token queued behind it in both experts' capacity, so the
    gradients are held with the reference run's routing pinned to the
    flash run's (``_pinned_routing``), within PARITY_GRAD_TOL; the
    gradients with free routing, and the share of the kept (token,
    expert) assignments that moved, are printed beside them."""
    losses, grad_norms, grads, masks = {}, {}, {}, {}
    tokens, targets = _moe_parity_tokens(MIXTRAL_WIDTHS["vocab_size"],
                                         MOE_MICRO, MOE_SEQ)
    # the rows the sp phase's (d) trains its MoE case on over tensor 2:
    # the flash run is that case's one-process reference
    fam = next(f for f in SP_TENSOR if f["family"] == "moe")
    for run, attn in (("flash", "flash"), ("reference", "reference"),
                      ("pinned", "reference")):
        cfg = mixtral_config(MOE_PARITY_LAYERS, attn)
        masks[run] = []
        with _pinned_routing(
                record=None if run == "pinned" else masks[run],
                replay=masks["flash"] if run == "pinned" else None):
            grads[run] = _one_step_grads(cfg, tokens, targets, _llama_moe)
        _free_memory()
        if run == "pinned":
            continue
        reset_counts()
        hist, launches = _train(cfg, MOE_MICRO, 3, MOE_MICRO,
                                model_cls=_llama_moe,
                                optimizer_factory=_adafactor,
                                data_source=iter(sp_tensor_batches(fam, 3)))
        losses[run] = [r["loss"] for r in hist]
        grad_norms[run] = [r["grad_norm"] for r in hist]
        if run == "flash":
            _SP_REFERENCES["moe"] = {
                "steps": [{"loss": r["loss"], "grad_norm": r["grad_norm"],
                           "ms": r["step_time_s"] * 1e3} for r in hist],
                "tokens": tokens.cpu(), "targets": targets.cpu(),
                "masks": [m.cpu() for m in masks["flash"]],
                "grads": sp_reference_grads(grads["flash"],
                                            MOE_PARITY_LAYERS)}
        want = _expected_launches(cfg, len(hist))
        if launches != want:
            raise AssertionError(f"moe {attn} parity run launches "
                                 f"{launches}, want {want}")
        _free_memory()
    # the (token, expert) assignments kept, by layer: a slot that moves
    # within an expert's queue computes the same, a changed expert not
    moved = [((a.any(-1) != b.any(-1)).sum() / a.any(-1).sum()).item()
             for a, b in zip(masks["flash"], masks["reference"])]
    free = {n: _rel_l2(grads["reference"][n], grads["flash"][n])
            for n in grads["flash"]}
    worst = sorted(free, key=free.get, reverse=True)[:4]
    log(f"parity (moe routing, {MOE_PARITY_LAYERS} layers): kept (token, "
        f"expert) assignments that differ between flash and reference, by "
        f"layer, per assignment kept: {moved}; one step's gradients with "
        f"free routing, "
        f"relative L2: worst " + ", ".join(f"{n} {free[n]:.3g}"
                                           for n in worst))
    losses["pinned"], grad_norms["pinned"] = (losses["reference"],
                                              grad_norms["reference"])
    _compare_runs(f"moe attention, {MOE_PARITY_LAYERS} layers, routing "
                  f"pinned", "flash", "pinned", losses, grad_norms, grads,
                  [f"layer_{i}.{p}" for i in range(MOE_PARITY_LAYERS)
                   for p in ("attn.k_proj.kernel", "moe.router",
                             "moe.ExpertMLP_0.wi")])
    out = {"moved_assignments_by_layer": moved,
           "free_routing_worst_grad_rel_l2": {n: free[n] for n in worst}}
    del grads, masks
    _free_memory()
    return out


def phase_moe(smi: str, profile: str = "") -> dict:
    """The Mixtral-style family: (a) Mixtral-8x7B's widths at 4 layers
    train through the loop (with ``profile``, one more step profiled into
    ``<profile>.moe``), (b) flash against reference at 2 layers, (c) the
    MoE example under the port's agent resumes from its checkpoint."""
    import os
    import shutil
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    out = {"seconds": {}}
    _free_memory()
    out["train"], out["launches"] = _moe_train(
        smi, f"{profile}.moe" if profile else "")
    out["seconds"]["train"] = time.monotonic() - t0
    mark = time.monotonic()
    out["parity"] = _moe_parity()
    out["seconds"]["parity"] = time.monotonic() - mark
    mark = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    agent_tmps = []
    try:
        agent_tmps = [tempfile.mkdtemp(prefix="agent_", dir=tmp)
                      for _ in range(2)]
        first = _example_run(repo, tmp, EXAMPLE_STEPS, "first",
                             agent_tmps[0], MOE_WORKER, "moe")
        if not any(line.startswith(f"moe: done step={EXAMPLE_STEPS} ")
                   for line in first):
            raise AssertionError(f"the MoE example did not finish step "
                                 f"{EXAMPLE_STEPS}: {first}")
        second = _example_run(repo, tmp, EXAMPLE_RESUMED_STEPS, "resumed",
                              agent_tmps[1], MOE_WORKER, "moe")
        new = second[len(first):]
        if not any(line.startswith(f"moe: start_step={EXAMPLE_STEPS} ")
                   for line in new):
            raise AssertionError(f"the MoE example did not resume at step "
                                 f"{EXAMPLE_STEPS}: {new}")
        if not any(line.startswith(f"moe: done step={EXAMPLE_RESUMED_STEPS} ")
                   for line in new):
            raise AssertionError(f"the resumed MoE example did not finish "
                                 f"step {EXAMPLE_RESUMED_STEPS}: {new}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"]["example"] = time.monotonic() - mark
    out["seconds"]["phase"] = time.monotonic() - t0
    log(f"moe: seconds by part {json.dumps(out['seconds'])}")
    return out


# ---------------------------------------------------------------------------
# pipeline: the circular schedule and PipelinedTrainer on the card
# ---------------------------------------------------------------------------

# Llama-1B through build_pipeline_trainer at pipe 1: two rounds of 11
# layers, 4 microbatches of 2 rows (the llama1b phase's 8 × 2048 tokens a
# step)
PIPE_ROUNDS = 2
PIPE_MICRO = 2
PIPE_MICROBATCHES = 4
PIPE_WARMUP, PIPE_TIMED = 2, 5
# (c) bound_activations: 1 warm-up and 3 timed steps, for the peak
PIPE_BOUND_TIMED = 3
# (b) times the dense trainer at the pipeline's microbatching too: the
# compared step as its warm-up, then these
PIPE_DENSE_TIMED = 3


def _pipeline_trainer(cfg, bound: bool = False):
    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.trainer.pipeline_trainer import (
        build_pipeline_trainer,
    )

    return build_pipeline_trainer(
        cfg, _adamw, None, PIPE_MICROBATCHES, PIPE_MICRO, cfg.max_seq_len,
        cross_entropy_loss, num_rounds=PIPE_ROUNDS, bound_activations=bound)


def _pipeline_launches(cfg, micro_steps: int, recompute: bool = False
                       ) -> dict:
    """``_expected_launches`` less the final norm's: the pipeline's exit
    normalises with the plain norm (the JAX exit's
    ``reference_rms_norm``), so the norm kernels run at the blocks' 2·L
    norms a microbatch (4·L forward under the recompute)."""
    want = _expected_launches(cfg, micro_steps, recompute)
    if cfg.norm_impl == "fused":
        want["rms_fwd"] -= micro_steps
        want["rms_bwd"] -= micro_steps
    return want


def _pipeline_run(cfg, steps: int, warmup: int, bound: bool,
                  profile_out: str = "") -> tuple:
    """(history, launches, result) of the pipelined trainer through
    ElasticTrainLoop; fails on non-finite losses or launches other than
    predicted."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    global_batch = PIPE_MICROBATCHES * PIPE_MICRO
    hist, launches = _train(cfg, global_batch, steps, PIPE_MICRO,
                            profile_out=profile_out,
                            trainer=_pipeline_trainer(cfg, bound))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    what = "pipeline (c)" if bound else "pipeline (a)"
    for r in hist:
        log(f"  {what} step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != steps or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in hist):
        raise AssertionError(f"{what}: {len(hist)} steps, losses "
                             f"{[r['loss'] for r in hist]}")
    want = _pipeline_launches(cfg, PIPE_MICROBATCHES * steps, bound)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    timed = hist[warmup:]
    times = [r["step_time_s"] * 1e3 for r in timed]
    result = {"step_median_ms": statistics.median(times),
              "step_min_ms": min(times), "step_max_ms": max(times),
              "tokens_per_s": global_batch * cfg.max_seq_len
              / statistics.mean(r["step_time_s"] for r in timed),
              "mfu": statistics.mean(r["mfu"] for r in timed),
              "peak_mem_gib": peak_gb,
              "launches_per_step": {n: c / steps
                                    for n, c in launches.items()}}
    return hist, launches, result


def _pipeline_against_dense(cfg) -> dict:
    """(b): one step of the pipelined trainer and one of the port's dense
    trainer (accum 4, micro 2) from the same weights on the same batch:
    the loss within PARITY_LOSS_TOL, the grad norm within
    PARITY_GRAD_NORM_TOL relative. Then PIPE_DENSE_TIMED more dense
    steps, timed: the dense step at the pipeline's microbatching, beside
    (a)'s."""
    import numpy as np

    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    rng = np.random.default_rng(5)
    rows = PIPE_MICROBATCHES * PIPE_MICRO
    tokens, targets = (rng.integers(0, cfg.vocab_size,
                                    (rows, cfg.max_seq_len))
                       for _ in range(2))
    trainer = _pipeline_trainer(cfg)
    state = trainer.init(0)
    weights = {n: p.detach().cpu() for n, p in
               state.model.state_dict().items()}
    state, piped = trainer.step(state, *trainer.shard_batch(tokens, targets))
    piped = {k: v.item() for k, v in piped.items()}
    del state, trainer
    _free_memory()
    dense = build_trainer(functools.partial(Llama, cfg), _adamw, None,
                          np.zeros((PIPE_MICRO, cfg.max_seq_len)),
                          cross_entropy_loss,
                          accum_steps=PIPE_MICROBATCHES,
                          micro_batch=PIPE_MICRO)
    dstate = dense.init(0)
    dstate.model.load_state_dict(weights)
    del weights
    dstate, flat = dense.step(dstate, *dense.shard_batch(tokens, targets))
    flat = {k: v.item() for k, v in flat.items()}
    times = []
    for _ in range(PIPE_DENSE_TIMED):
        t0 = time.monotonic()
        dstate, metrics = dense.step(dstate, *dense.shard_batch(tokens,
                                                                targets))
        metrics["loss"].item()
        times.append((time.monotonic() - t0) * 1e3)
    del dstate, dense
    _free_memory()
    out = {"pipeline": piped, "dense": flat,
           "dense_step_median_ms": statistics.median(times),
           "dense_step_ms": times,
           "loss_diff": abs(piped["loss"] - flat["loss"]),
           "grad_norm_rel_diff": abs(piped["grad_norm"] - flat["grad_norm"])
           / flat["grad_norm"]}
    log(f"pipeline (b): pipelined {piped} dense {flat}: loss diff "
        f"{out['loss_diff']:.3g} (tolerance {PARITY_LOSS_TOL}), grad norm "
        f"relative diff {out['grad_norm_rel_diff']:.3g} (tolerance "
        f"{PARITY_GRAD_NORM_TOL}); the dense step at accum "
        f"{PIPE_MICROBATCHES}, micro {PIPE_MICRO}: {times} ms")
    if not (out["loss_diff"] <= PARITY_LOSS_TOL
            and out["grad_norm_rel_diff"] <= PARITY_GRAD_NORM_TOL):
        raise AssertionError("pipeline (b): the pipelined step disagrees "
                             "with the dense one")
    return out


def _pipeline_loop(cfg, ckpt_dir: str, steps: int):
    from dlrover_tpu_torch.models.llama import Llama
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    return ElasticTrainLoop(
        functools.partial(Llama, cfg), None, None,
        TrainLoopConfig(global_batch=PIPE_MICROBATCHES * PIPE_MICRO,
                        seq_len=cfg.max_seq_len,
                        max_micro_per_replica=PIPE_MICRO, max_steps=steps,
                        checkpoint_dir=ckpt_dir, save_interval_steps=3,
                        report_interval_steps=0),
        trainer=_pipeline_trainer(cfg))


def _pipeline_resume(smi: str) -> dict:
    """(d): the pipelined trainer at CKPT_LAYERS (two rounds of 2) through
    the loop with its checkpointer: A 5 steps saving at 3, B a new loop
    restoring 3 trains 4-5, the same bits as A."""
    import shutil
    import tempfile

    cfg = ckpt_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        free = shutil.disk_usage(tmp).free
        state_bytes = 3 * 4 * cfg.param_count()
        log(f"pipeline (d): checkpoints in {tmp}, {free / 1e9:.1f} GB free, "
            f"one is {state_bytes / 1e9:.2f} GB ({smi})")
        if free < 1.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free: less than one "
                                 f"checkpoint")
        loop = _pipeline_loop(cfg, tmp, 3)
        sampler, data = _sampler_and_data(cfg)
        state, _ = loop.restore_or_init(0, sampler)
        state, m1 = loop.run(state, data, 0, sampler)
        loop.checkpointer.save_interval_steps = 0
        loop.config.max_steps = 2
        state, m2 = loop.run(state, data, 3, sampler)
        hist_a = m1["history"] + m2["history"]
        save = dict(loop.checkpointer.last_save)
        loop.close()
        del state, loop
        _free_memory()
        loop = _pipeline_loop(cfg, tmp, 2)
        sampler, data = _sampler_and_data(cfg)
        state, start = loop.restore_or_init(0, sampler)
        source = loop.last_restore_source
        restore = dict(loop.last_restore_timings)
        state, m3 = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        _free_memory()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a = [(r["loss"], r["grad_norm"]) for r in hist_a]
    b = [(r["loss"], r["grad_norm"]) for r in m3["history"]]
    out = {"a": a, "b": b, "start": start, "source": source,
           "blocking_save_s": save.get("blocking_s"),
           "commit_s": save.get("commit_s"),
           "dcp_read_s": restore.get("dcp_read_s")}
    log(f"pipeline (d): {json.dumps(out)}")
    if start != 3 or source != "checkpoint" or b != a[3:]:
        raise AssertionError(f"pipeline (d): resumed at {start} from "
                             f"{source!r}, steps 4-5 {b}, want {a[3:]}")
    return out


def phase_pipeline(smi: str, llama1b: dict, profile: str = "") -> dict:
    """The circular pipeline on the card: (a) Llama-1B through
    build_pipeline_trainer at pipe 1 and ElasticTrainLoop (with
    ``profile``, one more step profiled into ``<profile>.pipeline``), (b)
    the same weights through the dense trainer, and its step at the
    pipeline's microbatching, (c) bound_activations (profiled into
    ``<profile>.pipeline_bound``), (d) a save and a bit-exact resume at
    CKPT_LAYERS."""
    from dlrover_tpu_torch.models.llama import LlamaConfig

    t0 = time.monotonic()
    out = {"card": smi, "seconds": {}}
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    _free_memory()
    steps = PIPE_WARMUP + PIPE_TIMED
    hist, out["launches"], out["a"] = _pipeline_run(
        cfg, steps, PIPE_WARMUP, False,
        f"{profile}.pipeline" if profile else "")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"pipeline (a): first loss {hist[0]['loss']} "
                             f"is not near ln(vocab)")
    if llama1b:
        out["a"]["llama1b_step_median_ms"] = llama1b["step_median_ms"]
        out["a"]["llama1b_peak_mem_gib"] = llama1b["peak_mem_gb"]
    log(f"pipeline (a): {json.dumps(out['a'])} ({smi})")
    out["seconds"]["a"] = time.monotonic() - t0
    mark = time.monotonic()
    out["b"] = _pipeline_against_dense(cfg)
    out["seconds"]["b"] = time.monotonic() - mark
    mark = time.monotonic()
    _free_memory()
    _, _, out["c"] = _pipeline_run(
        cfg, 1 + PIPE_BOUND_TIMED, 1, True,
        f"{profile}.pipeline_bound" if profile else "")
    log(f"pipeline (c) bound_activations: {json.dumps(out['c'])} beside "
        f"(a)'s step {out['a']['step_median_ms']:.1f} ms and peak "
        f"{out['a']['peak_mem_gib']:.2f} GiB ({smi})")
    out["seconds"]["c"] = time.monotonic() - mark
    mark = time.monotonic()
    _free_memory()
    out["d"] = _pipeline_resume(smi)
    out["seconds"]["d"] = time.monotonic() - mark
    out["seconds"]["phase"] = time.monotonic() - t0
    log(f"pipeline: seconds {json.dumps(out['seconds'])} ({smi})")
    return out


# ---------------------------------------------------------------------------
# embedding: the job manager and elastic embedding training
# ---------------------------------------------------------------------------

# A CTR model at the scale of the MLPerf Training DLRM reference on
# Criteo 1TB (mlcommons/training recommendation_v2/torchrec_dlrm: 26
# categorical fields, embedding dim 128, top MLP 1024-1024-512-256-1,
# tables capped at 40M rows): the 26 fields hashed into one table of
# EMB_ROWS rows (cut from 40M: the row-sparse update holds ≈8 table-sized
# tensors, ≈164 GB at 40M), batch 2048, BCE on 0/1 labels
EMB_ROWS, EMB_DIM, EMB_FIELDS, EMB_BATCH = 10_000_000, 128, 26, 2048
EMB_TOP_MLP = (1024, 1024, 512, 256, 1)
EMB_SEED = 0
EMB_STEPS, EMB_SAVE_EVERY = 7, 3
EMB_SHARD = 2 * EMB_BATCH                 # records a shard
EMB_RECORDS = 6 * EMB_SHARD               # records in the dataset
EMB_CLICK_RATE = 0.25
# each field's values follow a power law, as Criteo's categorical values
# do (a few values take most of the records): rank k of a field drawn
# with probability ∝ (k + 1)^-EMB_ZIPF_S over EMB_ROWS ranks, hashed to a
# row by one permutation, each field at its own offset. The hot rows
# take hundreds of ids a batch, so their accumulator moves (a row hit
# once gains a g² below half an ulp of Adagrad's initial 0.1)
EMB_ZIPF_S = 1.2
EMB_TUNED_BATCH = 1024                    # the batch size (d) merges
EMB_DATASET = "criteo-hashed"
# (a) the card's first 3 steps against the plain CPU run of the same
# steps from the same carried state (on the rows they touch: no other
# row moves): f32, the card's matmul and embedding-backward orders. The
# table's rows and the accumulator elementwise, and each by the relative
# L2 of its 3-step update (an update's error against the update's size:
# the elementwise bound alone admits an update off by tens of percent).
# The accumulator's looser: its 3-step increments are a few ulps of its
# 0.1 (g² of a hot row is 1e-9-1e-7), so one increment that the other
# order rounds to the next ulp is ≈1/150 of the update's L2, and an
# increment 10% off is ≈1e-1 of it. The tower's parameters by the relative L2
# of their update alone (Adam's first steps move an element by about lr
# whatever its gradient's size, so a near-zero gradient rounded to the
# other sign moves it the other way)
EMB_ROW_RTOL, EMB_ROW_ATOL = 1e-4, 1e-7
EMB_ROW_UPDATE_TOL = 1e-3
EMB_ACC_UPDATE_TOL = 5e-2
EMB_DENSE_UPDATE_TOL = 1e-2
EMB_LOSS_RTOL = 1e-5


class _CtrTower(torch.nn.Module):
    """The top MLP over the 26 looked-up rows concatenated (3328 wide):
    Linear layers of EMB_TOP_MLP, ReLU between them, one logit a row."""

    def __init__(self, device):
        super().__init__()
        layers, width = [], EMB_FIELDS * EMB_DIM
        for out in EMB_TOP_MLP:
            layers += [torch.nn.Linear(width, out, device=device),
                       torch.nn.ReLU()]
            width = out
        self.mlp = torch.nn.Sequential(*layers[:-1])

    def forward(self, emb):
        return self.mlp(emb.reshape(emb.shape[0], -1))[:, 0]


class _CtrRecords:
    """The dataset the master shards: record i is its 26 hashed ids and
    its label, one int64 row (made in bulk from the seed; the ids skewed
    as EMB_ZIPF_S says)."""

    def __init__(self, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        # the continuous power law's inverse CDF over [1, EMB_ROWS + 1)
        # (bounded Zipf), floored to a 0-based rank
        tail = 1.0 - (EMB_ROWS + 1.0) ** (1.0 - EMB_ZIPF_S)
        u = rng.random((EMB_RECORDS, EMB_FIELDS))
        ranks = np.minimum((1.0 - u * tail) ** (1.0 / (1.0 - EMB_ZIPF_S)),
                           EMB_ROWS).astype(np.int64) - 1
        offsets = np.arange(EMB_FIELDS) * (EMB_ROWS // EMB_FIELDS)
        self.rows = np.empty((EMB_RECORDS, EMB_FIELDS + 1), np.int64)
        self.rows[:, :EMB_FIELDS] = rng.permutation(EMB_ROWS)[
            (ranks + offsets) % EMB_ROWS]
        self.rows[:, EMB_FIELDS] = rng.random(EMB_RECORDS) < EMB_CLICK_RATE

    def __len__(self):
        return EMB_RECORDS

    def __getitem__(self, i):
        return self.rows[i]


def _ctr_bce(logits, labels):
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels)


def _ctr_trainer(rows: int, device):
    """(trainer, state) of the CTR model, its table and tower from
    EMB_SEED (the tower from the global generator, as nn.Linear does)."""
    from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from dlrover_tpu_torch.trainer.embedding import (
        ElasticEmbeddingTrainer,
        EmbeddingConfig,
        ShardedEmbedding,
    )

    generator = torch.Generator(device=device).manual_seed(EMB_SEED)
    embedding = ShardedEmbedding(EmbeddingConfig(rows, EMB_DIM),
                                 device=device, generator=generator)
    torch.manual_seed(EMB_SEED)
    trainer = ElasticEmbeddingTrainer(create_mesh(MeshSpec(), device),
                                      embedding, _CtrTower(device),
                                      _ctr_bce)
    return trainer, trainer.init()


def _split(batch):
    return batch[:, :EMB_FIELDS], batch[:, EMB_FIELDS].astype("float32")


def _carried(state, touched):
    """The card's state as ``load_state`` takes it, the table and its
    accumulator cut to the ``touched`` rows, on the host."""
    table = state.model.embedding.table
    embed_opt, dense_opt = state.optimizer
    params = {"embedding.table": table.detach()[touched].cpu()}
    opt = {"embedding.table": {"accumulator": embed_opt.state[table][
        "accumulator"][touched].cpu()}}
    for name, p in state.model.dense.named_parameters():
        params[f"dense.{name}"] = p.detach().cpu().clone()
        opt[f"dense.{name}"] = {k: v.detach().cpu().clone()
                                for k, v in dense_opt.state[p].items()}
    return params, opt


def _emb_parity(carried, touched, batches, card_losses, state) -> dict:
    """(a): the plain CPU run of ``batches`` from the carried state on the
    touched rows (ids renumbered into them) against the card's."""
    import numpy as np

    trainer, cpu = _ctr_trainer(len(touched), "cpu")
    trainer.load_state(cpu, *carried)
    step = trainer.build_step()
    order = touched.cpu().numpy()
    losses = []
    for ids, labels in batches:
        losses.append(float(step(cpu, np.searchsorted(order, ids), labels)))
    table = state.model.embedding.table
    card_rows = table.detach()[touched].cpu()
    card_acc = state.optimizer[0].state[table]["accumulator"][touched].cpu()
    cpu_table = cpu.model.embedding.table.detach()
    cpu_acc = cpu.optimizer[0].state[cpu.model.embedding.table][
        "accumulator"]
    start = carried[0]
    start_acc = carried[1]["embedding.table"]["accumulator"]

    def update_rel_l2(got, want, before):
        return float((got - want).norm()
                     / (want - before).norm().clamp_min(1e-30))

    errs = {"loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(card_losses, losses)),
            "table_max_abs": float((card_rows - cpu_table).abs().max()),
            "acc_max_abs": float((card_acc - cpu_acc).abs().max()),
            "table_update_rel_l2": update_rel_l2(
                card_rows, cpu_table, start["embedding.table"]),
            "acc_update_rel_l2": update_rel_l2(card_acc, cpu_acc, start_acc),
            # rows whose accumulator the CPU run moved: (a)'s accumulator
            # checks hold nothing when it is 0
            "acc_moved_rows": int((cpu_acc != start_acc).any(dim=1).sum())}
    ok = (errs["loss_rel"] <= EMB_LOSS_RTOL
          and torch.allclose(card_rows, cpu_table, rtol=EMB_ROW_RTOL,
                             atol=EMB_ROW_ATOL)
          and torch.allclose(card_acc, cpu_acc, rtol=EMB_ROW_RTOL,
                             atol=EMB_ROW_ATOL)
          and errs["table_update_rel_l2"] <= EMB_ROW_UPDATE_TOL
          and errs["acc_update_rel_l2"] <= EMB_ACC_UPDATE_TOL
          and errs["acc_moved_rows"] > 0)
    worst = 0.0
    for name, p in state.model.dense.named_parameters():
        want = dict(cpu.model.dense.named_parameters())[name].detach()
        before = start[f"dense.{name}"]
        moved = want - before
        worst = max(worst, float((p.detach().cpu() - want).norm()
                                 / moved.norm().clamp_min(1e-30)))
    errs["dense_update_rel_l2"] = worst
    ok = ok and worst <= EMB_DENSE_UPDATE_TOL
    errs["ok"] = bool(ok)
    errs["cpu_losses"] = losses
    return errs


def _same_bits(state, ref) -> bool:
    """The table, the accumulator and every tower parameter equal to
    ``ref``'s copies, bit for bit."""
    table = state.model.embedding.table
    if not (torch.equal(table.detach(), ref["table"]) and torch.equal(
            state.optimizer[0].state[table]["accumulator"], ref["acc"])):
        return False
    return all(torch.equal(p.detach(), ref["dense"][n])
               for n, p in state.model.dense.named_parameters())


def _snapshot(state) -> dict:
    table = state.model.embedding.table
    return {"table": table.detach().clone(),
            "acc": state.optimizer[0].state[table]["accumulator"].clone(),
            "dense": {n: p.detach().clone()
                      for n, p in state.model.dense.named_parameters()}}


def phase_embedding(smi: str, device: str = "cuda") -> dict:
    """Elastic embedding training at a 10M-row table under the port's
    job-managed master (see the module docstring). ``device`` "cpu" is
    the rehearsal at a cut size (the tests'); the card is the run."""
    import os
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.monitor import ParalConfigTuner
    from dlrover_tpu_torch.checkpoint.flash_checkpoint import (
        FlashCheckpointer,
    )
    from dlrover_tpu_torch.common.constants import (
        JobStage,
        NodeExitReason,
        NodeStatus,
        NodeType,
    )
    from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.scheduler.job import JobArgs, NodeArgs
    from dlrover_tpu_torch.scheduler.local import LocalCluster
    from dlrover_tpu_torch.trainer.dataloader import ShardedDataset
    from dlrover_tpu_torch.trainer.embedding import EmbeddingFailoverClient

    t_phase = time.monotonic()
    out = {"card": smi}
    timeline = []
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    peak_gib = ((lambda: torch.cuda.max_memory_allocated() / 2 ** 30)
                if on_card else (lambda: 0.0))
    if on_card:
        _free_memory()
        torch.cuda.reset_peak_memory_stats()

    def wait(pred, what: str, timeout_s: float = 10.0) -> None:
        end = time.monotonic() + timeout_s
        while not pred():
            if time.monotonic() > end:
                raise AssertionError(f"embedding: {what} within "
                                     f"{timeout_s:.0f} s")
            time.sleep(0.02)

    args = JobArgs(job_name="ctr")
    args.node_args[NodeType.WORKER] = NodeArgs(
        group_resource=NodeGroupResource(
            count=2, node_resource=NodeResource(cpu=8, memory_mb=65536,
                                                chips=1)),
        restart_count=1)
    cluster = LocalCluster()
    master = JobMaster(min_nodes=2, max_nodes=2, job_args=args,
                       cluster=cluster, host="127.0.0.1")
    master.prepare()
    manager = master.job_manager
    clients, ckpt = [], None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_embedding_")
    ckpt_root = ""
    try:
        wait(lambda: len(manager.get_running_workers()) == 2,
             "two running workers")
        client = MasterClient(master.addr, node_id=0, node_rank=0)
        peer = MasterClient(master.addr, node_id=1, node_rank=1)
        clients += [client, peer]
        records = _CtrRecords(EMB_SEED)
        # the agent's ParalConfigTuner writes the tuned config here; the
        # feed reloads its batch size from it at batch boundaries
        config = os.path.join(tmp, "paral_config.json")
        feed = ShardedDataset(client, EMB_DATASET, records, EMB_BATCH,
                              wait_poll_s=0.05, config_file=config)
        feed.register(shard_size=EMB_SHARD, num_epochs=1)
        # worker 1 holds a shard in flight when it dies
        held = peer.get_task(EMB_DATASET)
        batches = iter(feed)

        t0 = time.monotonic()
        trainer, state = _ctr_trainer(EMB_ROWS, device)
        sync()
        out["init_s"] = time.monotonic() - t0
        table = state.model.embedding.table
        table_bytes = table.numel() * table.element_size()
        state_bytes = 2 * table_bytes + 3 * sum(
            p.numel() * 4 for p in state.model.dense.parameters())
        mem = host_memory()
        on_shm = min(mem["shm_free"], mem["MemAvailable"] - 2 * state_bytes
                     ) >= 2.2 * state_bytes
        ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_embedding_ckpt_",
                                     dir="/dev/shm" if on_shm else tmp)
        free = shutil.disk_usage(ckpt_root).free
        log(f"embedding: table {EMB_ROWS} x {EMB_DIM} f32 "
            f"({table_bytes / 1e9:.2f} GB), state {state_bytes / 1e9:.2f} GB;"
            f" checkpoints in {ckpt_root} "
            f"({'/dev/shm' if on_shm else 'disk'}, {free / 1e9:.1f} GB free;"
            f" two kept); host MemAvailable "
            f"{mem['MemAvailable'] / 1e9:.1f} GB ({smi})")
        if free < 2.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free: less than two "
                                 f"checkpoints")
        init_table = table.detach().clone()
        acc0 = float(state.optimizer[0].state[table]["accumulator"][0, 0])
        failover = EmbeddingFailoverClient(client)
        if failover.start() != 0:
            raise AssertionError("the global version is not 0 at start")
        timeline.append(("start", failover.local_version))

        step = trainer.build_step()
        # (a)'s carried state: the rows steps 1-3 touch, before step 1
        seen = {i: _split(next(batches)) for i in (1, 2, 3)}
        parity_rows = torch.from_numpy(np.unique(np.concatenate(
            [seen[i][0].ravel() for i in (1, 2, 3)]))).to(device)
        carried = _carried(state, parity_rows)
        losses, step_ms, saves = [], [], {}
        ckpt = FlashCheckpointer(ckpt_root, save_interval_steps=EMB_SAVE_EVERY)
        reset_counts()
        for i in range(1, EMB_STEPS + 1):
            if i not in seen:
                seen[i] = _split(next(batches))
            sync()
            t0 = time.monotonic()
            losses.append(float(step(state, *seen[i])))
            step_ms.append((time.monotonic() - t0) * 1e3)
            if ckpt.maybe_save(i, state, {"step": i,
                                          "records": i * EMB_BATCH}):
                # the committer adds commit_s to this save's dict
                saves[i] = ckpt.last_save
            if i == 3:
                # on the host while the step-3 commit runs
                parity = _emb_parity(carried, parity_rows,
                                     [seen[k] for k in (1, 2, 3)],
                                     losses[:3], state)
                out["parity"] = parity
                log(f"embedding (a): 3 card steps against the plain CPU "
                    f"run from the carried state on "
                    f"{len(parity_rows)} touched rows: "
                    f"{json.dumps(parity)}")
                if not parity["ok"]:
                    raise AssertionError(f"embedding (a): the card's steps "
                                         f"disagree with the CPU run: "
                                         f"{parity}")
        out["train_peak_gib"] = peak_gib()
        # (a): no row the 7 steps' ids missed moved, in the table or
        # the accumulator
        touched = torch.zeros(EMB_ROWS, dtype=torch.bool, device=device)
        for i in seen:
            touched[torch.from_numpy(seen[i][0].ravel()).to(device)] = True
        acc = state.optimizer[0].state[table]["accumulator"]
        moved = (table.detach() != init_table).any(dim=1)
        acc_moved = (acc != acc0).any(dim=1)
        out["rows"] = {"touched": int(touched.sum()),
                       "moved": int(moved.sum()),
                       "acc_moved": int(acc_moved.sum()),
                       "untouched_moved": int((moved & ~touched).sum()),
                       "untouched_acc_moved": int((acc_moved & ~touched)
                                                  .sum())}
        del init_table, moved, acc_moved
        log(f"embedding (a): rows over the 7 steps {json.dumps(out['rows'])}")
        if out["rows"]["untouched_moved"] or out["rows"][
                "untouched_acc_moved"] or not out["rows"]["acc_moved"]:
            raise AssertionError(f"embedding (a): untouched rows moved, or "
                                 f"no accumulator row: {out['rows']}")

        # -- (b) a worker dies --------------------------------------------
        counts_before = client.get_task_counts(EMB_DATASET)
        victim = [n for n in manager.get_running_workers() if n.id == 1][0]
        t_fail = time.monotonic()
        cluster.fail_pod(victim.name, NodeExitReason.UNKNOWN_ERROR)
        wait(lambda: client.get_cluster_version("global") >= 1,
             "the global version rising")
        t_bump = time.monotonic()
        wait(lambda: len(manager.get_running_workers()) == 2
             and any(n.relaunch_count == 1 and n.status == NodeStatus.RUNNING
                     for n in manager.get_nodes(NodeType.WORKER)),
             "the relaunch running")
        t_relaunched = time.monotonic()
        replacement = [n for n in manager.get_running_workers()
                       if n.relaunch_count == 1][0]
        counts_after = client.get_task_counts(EMB_DATASET)
        version = client.get_cluster_version("global")
        timeline.append(("worker-1 failed", version))
        stale = failover.needs_reconcile()
        out["failure"] = {
            "global_version": version, "tasks_before": counts_before,
            "tasks_after": counts_after, "held_task": held.task_id,
            "replacement": [replacement.name, replacement.rank_index,
                            replacement.relaunch_count,
                            replacement.max_relaunch_count],
            "fail_to_bump_s": t_bump - t_fail,
            "fail_to_relaunch_running_s": t_relaunched - t_fail,
            "needs_reconcile": stale}
        log(f"embedding (b): {json.dumps(out['failure'])}")
        if (version != 1 or not stale
                or counts_after != (counts_before[0] + 1,
                                    counts_before[1] - 1)
                or replacement.rank_index != victim.rank_index
                or replacement.relaunch_count > replacement.max_relaunch_count):
            raise AssertionError(f"embedding (b): {out['failure']}")

        # a step on the stale view (step 8), then the uninterrupted run
        # from the step-6 checkpoint is steps 7 and 8 as they ran
        seen[EMB_STEPS + 1] = _split(next(batches))
        losses.append(float(step(state, *seen[EMB_STEPS + 1])))
        uninterrupted = _snapshot(state)

        # -- (c) reconcile ------------------------------------------------
        # the step-6 save's host copy: the committed bits
        host = dict(ckpt.exact_host_items())
        committed = {
            "table": host["model.embedding.table"],
            "accumulator": host["optim.state.embedding.table.accumulator"]}
        t0 = time.monotonic()
        result = trainer.maybe_reconcile(failover, ckpt, state)
        sync()
        restore_s = time.monotonic() - t0
        timeline.append(("reconciled (local)", failover.local_version))
        restored_bits = (
            torch.equal(table.detach(), committed["table"].to(device))
            and torch.equal(state.optimizer[0].state[table]["accumulator"],
                            committed["accumulator"].to(device)))
        # the relaunched worker adopts and publishes the global version
        clients.append(MasterClient(master.addr, node_id=replacement.id,
                                    node_rank=replacement.rank_index))
        EmbeddingFailoverClient(clients[-1]).start()
        live = sorted([0, replacement.id])
        reconciled_cluster = failover.wait_reconciled_cluster(live,
                                                              timeout_s=10)
        seen_local = client.get_cluster_version("local", task_id=0)
        replay = [float(step(state, *seen[i]))
                  for i in range(result.step + 1, EMB_STEPS + 2)]
        replay_bits = _same_bits(state, uninterrupted)
        del uninterrupted
        launches = read_counts()
        out["launches"] = launches
        out["reconcile"] = {
            "reconciled": result.reconciled, "step": result.step,
            "state_step_after_replay": state.step,
            "data_state": result.data_state, "committed_bits": restored_bits,
            "local_version": failover.local_version,
            "local_seen_by_master": seen_local, "live_ids": live,
            "wait_reconciled_cluster": reconciled_cluster,
            "replayed_losses": replay,
            "uninterrupted_losses": losses[result.step:],
            "replay_same_bits": replay_bits, "restore_s": restore_s,
            "restore_phases": dict(ckpt.last_restore_phases)}
        log(f"embedding (c): {json.dumps(out['reconcile'])}")
        if not (result.reconciled
                and result.step == EMB_STEPS - EMB_STEPS % EMB_SAVE_EVERY
                and result.data_state == {"step": result.step,
                                          "records": result.step * EMB_BATCH}
                and restored_bits and seen_local == 1
                and failover.local_version == 1 and reconciled_cluster
                and replay == losses[result.step:] and replay_bits):
            raise AssertionError(f"embedding (c): {out['reconcile']}")
        if any(launches.values()):
            raise AssertionError(f"embedding: a kernel launched on the "
                                 f"embedding path: {launches}")

        # -- (d) the tuned batch size reaches the live feed ---------------
        first = len(seen[EMB_STEPS + 1][0])
        merged = master.servicer.merge_paral_config(
            dataloader_batch_size=EMB_TUNED_BATCH)
        wrote = ParalConfigTuner(client, config).poll_once()
        tuned = _split(next(batches))
        tuned_loss = float(step(state, *tuned))
        out["batch_reload"] = {"before": first, "merged_version":
                               merged.version, "tuner_wrote": wrote,
                               "after": len(tuned[0]),
                               "loss_at_the_tuned_batch": tuned_loss}
        log(f"embedding (d): {json.dumps(out['batch_reload'])}")
        if ((first, len(tuned[0]), wrote) != (EMB_BATCH, EMB_TUNED_BATCH,
                                              True)
                or not math.isfinite(tuned_loss)):
            raise AssertionError(f"embedding (d): {out['batch_reload']}")

        # -- (e) the stage, the exporter, a clean stop --------------------
        stage = client.get_job_status().stage
        url = f"http://127.0.0.1:{master.metrics_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as reply:
            scraped = reply.status, reply.read().decode()
        for c in clients:
            c.close()
        clients = []
        t0 = time.monotonic()
        master.stop()
        stop_s = time.monotonic() - t0
        wait(lambda: not any(t.name == "node-monitor"
                             for t in threading.enumerate()),
             "the node monitor ending")
        try:
            urllib.request.urlopen(url, timeout=5)
            exporter_closed = False
        except (urllib.error.URLError, OSError):
            exporter_closed = True
        exits = master.metric_collector._reporter.records("job_exit")
        out["stop"] = {"job_stage": stage, "metrics_status": scraped[0],
                       "metrics_bytes": len(scraped[1]), "stop_s": stop_s,
                       "exporter_closed": exporter_closed,
                       "job_exit": exits[-1]["stage"] if exits else None}
        log(f"embedding (e): {json.dumps(out['stop'])}")
        if (stage != JobStage.RUNNING or scraped[0] != 200
                or "dlrover_tpu_checkpoint_saves_total" not in scraped[1]
                or not exporter_closed
                or out["stop"]["job_exit"] != JobStage.RUNNING):
            raise AssertionError(f"embedding (e): {out['stop']}")

        out["steps"] = {"losses": losses, "step_ms": step_ms,
                        "median_ms": statistics.median(step_ms[1:]),
                        "min_ms": min(step_ms[1:]),
                        "max_ms": max(step_ms[1:]),
                        "first_ms": step_ms[0]}
        save_times = {step_: [v.get(k) for k in ("blocking_s", "host_alloc_s",
                                                 "wait_s", "commit_s")]
                      for step_, v in saves.items()}
        out["saves"] = save_times
        out["peak_gib"] = peak_gib()
        out["timeline"] = timeline
        out["phase_s"] = time.monotonic() - t_phase
        log(f"embedding on {smi}: steps 2-{EMB_STEPS} median "
            f"{out['steps']['median_ms']:.2f} ms (min "
            f"{out['steps']['min_ms']:.2f}, max {out['steps']['max_ms']:.2f};"
            f" step 1 {step_ms[0]:.1f}), losses {losses}; allocator peak "
            f"{out['train_peak_gib']:.2f} GiB over the steps, "
            f"{out['peak_gib']:.2f} GiB in the phase; saves (blocking, "
            f"of it page-locking, the wait for the previous commit, "
            f"commit) {json.dumps(save_times)};"
            f" restore {restore_s:.2f} s (read "
            f"{ckpt.last_restore_phases.get('tensor_read_s', 0.0):.2f} s); "
            f"versions {timeline}; phase {out['phase_s']:.1f} s")
    finally:
        for c in clients:
            c.close()
        if ckpt is not None:
            ckpt.close()
        master.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        if ckpt_root:
            shutil.rmtree(ckpt_root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# brain: the brain, the fleet controller and the operator
# ---------------------------------------------------------------------------

# the fleet controller's knobs, the JAX acceptance test's
# (tests/test_fleet_controller.py _ACCEPT_KNOBS); the loop's own cadence
# (30 s) is set past the phase: the phase evaluates once, right after the
# offer lands, as the acceptance test does
BRAIN_KNOBS = dict(fleet_controller_enabled=True,
                   autoscale_hysteresis_windows=1, autoscale_cooldown_s=0.0,
                   autoscale_max_decisions_per_hour=100,
                   autoscale_claim_margin=1.2, goodput_window_s=30.0,
                   autoscale_interval_s=3600.0)
BRAIN_MICRO = 2            # micro (and global) batch of each replica
# rank 0's step the master's offer fires at: past the steps whose build
# the goodput window still holds, so that the measured goodput prices
# the claim above its margin
BRAIN_OFFER_AT = 30
BRAIN_REVOKE_AT = 8        # rank 1's step its revoke notice fires at
BRAIN_AFTER = 5            # rank 0's steps in the world of 1 after the drain
BRAIN_JOB = "llama-1b-brain"


def _load_fake_k8s(repo: str):
    """tests/fake_k8s.py (stdlib only), loaded by path."""
    import importlib.util
    import os

    path = os.path.join(repo, "tests", "fake_k8s.py")
    spec = importlib.util.spec_from_file_location("fake_k8s", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _brain_operator(repo: str, master_addr: str, smi: str) -> dict:
    """(d) The operator: one ElasticJob reconciled by the native table
    against the fake API server (master pod, phase Running, a ScalePlan
    relayed to the phase's master), and the pod scaler's worker pods
    requesting their cards as nvidia.com/gpu."""
    from dlrover_tpu_torch import native_build
    from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
    from dlrover_tpu_torch.master.scaler.base import ScalePlan
    from dlrover_tpu_torch.master.scaler.pod_scaler import PodScaler
    from dlrover_tpu_torch.operator import native
    from dlrover_tpu_torch.operator.crd import ElasticJob
    from dlrover_tpu_torch.operator.k8s_operator import K8sElasticJobOperator
    from dlrover_tpu_torch.scheduler.kubernetes import K8sApi, K8sClient

    def wait(pred, what: str, timeout_s: float = 10.0) -> None:
        end = time.monotonic() + timeout_s
        while not pred():
            if time.monotonic() > end:
                raise AssertionError(f"brain (d): {what} within "
                                     f"{timeout_s:.0f} s")
            time.sleep(0.02)

    card = smi.split(",")[0].strip()
    job = {"apiVersion": "elastic.dlrover-tpu.org/v1alpha1",
           "kind": "ElasticJob",
           "metadata": {"name": "llama", "namespace": "default",
                        "uid": "u-1"},
           "spec": {"replicaSpecs": {"worker": {
               "replicas": 2, "restartCount": 1,
               "template": {"spec": {
                   "containers": [{
                       "name": "main", "image": "dlrover-tpu-torch",
                       "command": ["/bin/sh", "-c", "python -m "
                                   "dlrover_tpu_torch.run llama_train.py"],
                       "resources": {"limits": {
                           "cpu": "8", "memory": "96Gi",
                           "nvidia.com/gpu": "1"}}}],
                   "nodeSelector": {
                       "cloud.google.com/gke-accelerator": card}}}}}}}
    fake = _load_fake_k8s(repo).FakeK8s()
    host = fake.start()
    operator = None
    try:
        path = native_build.so_path()
        lib = native_build.load_native()
        client = K8sClient("default", api=K8sApi(host=host, token="t"))
        fake.elasticjobs["llama"] = job
        calls = native.native_calls
        operator = K8sElasticJobOperator(client=client,
                                         reconcile_interval_s=0.05)
        operator.start()
        wait(lambda: "llama-master-0" in fake.pods, "the master pod")
        fake.set_pod_phase("llama-master-0", "Running")
        wait(lambda: any(p["body"].get("status", {}).get("phase")
                         == "Running" and "elasticjobs/llama" in p["path"]
                         for p in fake.patches), "phase Running")
        controller = operator._controllers["llama"]
        controller.master_addr = master_addr
        wait(lambda: fake.watcher_count("scaleplans") > 0, "the plan watch")
        fake.push_event("scaleplans", "ADDED", {
            "metadata": {"name": "keep"},
            "spec": {"ownerJob": "llama",
                     "replicaResourceSpecs": {"worker": {"replicas": 1}}}})
        wait(lambda: any("scaleplans/keep/status" in p["path"]
                         for p in fake.patches), "the plan relayed")
        wait(lambda: not controller.pending_scale_plans,
             "the relay drained")
        operator.stop()
        operator = None
        native_used = native.native_calls - calls
        # the worker pods the master's pod scaler creates for the CR
        worker = ElasticJob.from_manifest(job).spec.replica_specs["worker"]
        scaler = PodScaler("llama", client, master_addr, image=worker.image,
                           command=worker.command, retry_interval_s=0.05)
        scaler.start()
        try:
            scaler.scale(ScalePlan(node_group_resources={
                "worker": NodeGroupResource(
                    count=2, node_resource=NodeResource(
                        cpu=worker.resource.cpu,
                        memory_mb=worker.resource.memory_mb,
                        chips=worker.resource.chips,
                        chip_type=worker.resource.chip_type))}))
            wait(lambda: sum(1 for n in fake.pods if "-worker-" in n) == 2,
                 "two worker pods")
        finally:
            scaler.stop()
        limits = [fake.pods[n]["spec"]["containers"][0]["resources"][
            "limits"] for n in sorted(fake.pods) if "-worker-" in n]
        out = {"library": str(path), "abi": lib.reconciler_abi_version(),
               "native_calls": native_used, "master_pod": sorted(fake.pods)[0],
               "phases_patched": [p["body"]["status"]["phase"]
                                  for p in fake.patches
                                  if "elasticjobs/llama" in p["path"]],
               "plans_relayed": [p["path"].split("/")[-2]
                                 for p in fake.patches
                                 if "scaleplans/" in p["path"]],
               "worker_limits": limits}
        log(f"brain (d) operator: {json.dumps(out)}")
        if (path.parent.name != "native" or path.parent.parent.name
                != "build" or native_used < 2
                or out["plans_relayed"] != ["keep"]
                or "Running" not in out["phases_patched"]
                or [lim.get("nvidia.com/gpu") for lim in limits]
                != ["1", "1"]
                or any("google.com/tpu" in lim for lim in limits)):
            raise AssertionError(f"brain (d): {out}")
        return out
    finally:
        if operator is not None:
            operator.stop()
        fake.stop()


def phase_brain(smi: str, device: str = "cuda") -> dict:
    """A Llama-1B job on the card under a brain-optimised,
    fleet-controlled master: the brain's records and plan, a claim whose
    grant joins a second replica, a revoke that drains it, and the
    operator (see the module docstring). ``device`` "cpu" is the
    rehearsal with the tiny model, without the card's checks (kernel
    launches, allocator peaks); the card is the run."""
    import os
    import re
    import shutil
    import tempfile
    import threading

    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.brain.client import BrainClient
    from dlrover_tpu_torch.brain.datastore import MetricsStore
    from dlrover_tpu_torch.brain.service import BrainService
    from dlrover_tpu_torch.common.bootstrap import publish_or_wait_coordinator
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.common.constants import (
        JobStage,
        NodeType,
        RendezvousName,
    )
    from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.scheduler.job import JobArgs, NodeArgs
    from dlrover_tpu_torch.scheduler.local import LocalCluster
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_brain_")
    on_card = device == "cuda"
    if on_card:
        cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                                   norm_impl="fused", embed_impl="gather")
        worker_cfg = ["--config", "llama_1b"]
    else:
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        worker_cfg = ["--config", "tiny", "--device", "cpu"]
    out = {"card": smi}
    ctx = Context.singleton()
    saved = {k: getattr(ctx, k) for k in BRAIN_KNOBS}
    ctx.update(**BRAIN_KNOBS)
    if on_card:
        _free_memory()
        torch.cuda.reset_peak_memory_stats()
    brain = BrainService(store=MetricsStore(f"{tmp}/brain.sqlite"), port=0,
                         host="127.0.0.1")
    brain.start()
    brain_addr = f"127.0.0.1:{brain.port}"
    args = JobArgs(job_name=BRAIN_JOB, optimize_mode="cluster")
    args.node_args[NodeType.WORKER] = NodeArgs(
        group_resource=NodeGroupResource(
            count=1, node_resource=NodeResource(cpu=8, memory_mb=98304,
                                                chips=1)),
        restart_count=1)
    master = JobMaster(min_nodes=1, max_nodes=2, job_args=args,
                       cluster=LocalCluster(), host="127.0.0.1",
                       brain_addr=brain_addr)
    # the market's offer, through the master's injector at rank 0's step
    master._arm_master_chaos(f"offer:slice:+1@{BRAIN_OFFER_AT}")
    master.prepare()
    mgr = master.rdzv_managers[RendezvousName.TRAINING]
    provider, controller = master.capacity_provider, master.fleet_controller
    client0 = MasterClient(master.addr, node_id=0, node_rank=0,
                           timeout_s=30.0)
    stop = threading.Event()
    marks, proc, files, worker = {}, None, [], None
    log1 = f"{tmp}/rank1.log"
    agent_tmp = tempfile.mkdtemp(prefix="agent_", dir=tmp)

    def world_of(n: int, what: str, timeout_s: float = 120.0) -> float:
        """Until rank 0's world has ``n`` members; then, as rank 0's agent
        would, publish the round's process-group address (rank 1's agent
        waits for it; the solo replicas never dial it)."""
        end = time.monotonic() + timeout_s
        while True:
            rdzv_round, _, world = client0.get_comm_world()
            if len(world) == n:
                publish_or_wait_coordinator(
                    client0, f"coord/{RendezvousName.TRAINING}/"
                    f"{rdzv_round}", 0, 60.0)
                return time.time()
            if time.monotonic() > end:
                raise AssertionError(f"brain: no world of {n} {what} "
                                     f"within {timeout_s:.0f} s ({world})")
            time.sleep(0.05)

    def rank1_runs():
        return _worker_log(log1) if os.path.exists(log1) else []

    def grant(offer):
        # the new capacity: rank 1's agent around a second solo replica
        # on the card, admitted to the next round with rank 0 (whose
        # agent this process plays: it re-joins)
        nonlocal proc, files
        marks["grant"] = time.time()
        mgr.add_alive_node(1)
        proc, files = _spawn_agent(
            master, worker_cfg + ["--steps", "10000",
                     "--global-batch", str(BRAIN_MICRO), "--max-micro",
                     str(BRAIN_MICRO), "--report-interval", "1",
                     "--solo-replica", "--log-file", log1],
            {"DLROVER_TPU_CHAOS": f"revoke:slice:1@{BRAIN_REVOKE_AT}",
             "DLROVER_TPU_SLICE_ID": "1",
             "DLROVER_TPU_REPORT_RESOURCE_INTERVAL_S": "1",
             "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"},
            f"{tmp}/agent1.out", f"{tmp}/agent1.err", agent_tmp, repo,
            # the agent joins sliceless (``--slice-id -1``), so the two
            # replicas share one world; its worker inherits
            # DLROVER_TPU_SLICE_ID=1, which arms the market's revoke
            run_args=("--node-rank", "1", "--devices-per-node", "1",
                      "--monitor-interval", "0.5", "--slice-id", "-1"))
        client0.join_rendezvous(local_world_size=1)
        return [1]

    provider.grant_fn = grant
    try:
        client0.join_rendezvous(local_world_size=1)
        world_of(1, "at the start")
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
            TrainLoopConfig(global_batch=BRAIN_MICRO, seq_len=cfg.max_seq_len,
                            max_micro_per_replica=BRAIN_MICRO,
                            report_interval_steps=1),
            master_client=client0, device=device)
        sampler = ElasticDistributedSampler(dataset_size=10 ** 6,
                                            shuffle=True, seed=0)
        state, start = loop.restore_or_init(0, sampler)
        data = batches(synthetic_corpus(cfg.vocab_size), sampler,
                       BRAIN_MICRO, cfg.max_seq_len)
        fed = []           # the wall clock at each batch handed out

        def feed():
            for batch in data:
                if stop.is_set():
                    return
                fed.append(time.time())
                yield batch

        reset_counts()
        result = {}

        def train():
            try:
                result["state"], result["metrics"] = loop.run(
                    state, feed(), start, sampler)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                result["error"] = e

        worker = threading.Thread(target=train, name="rank0-train")
        worker.start()

        # -- (b) the offer → the claim → a world of 2 --------------------
        end = time.monotonic() + 300
        while not provider.open_offers():
            if time.monotonic() > end or not worker.is_alive():
                raise AssertionError(f"brain: no offer by rank 0's step "
                                     f"{BRAIN_OFFER_AT} ({result})")
            time.sleep(0.01)
        offer = provider.open_offers()[0]
        # one evaluation, as the controller's loop makes one at its
        # cadence; more only while the window's evidence is short of the
        # claim's margin (counted)
        evaluations, record = 0, None
        end = time.monotonic() + 60
        while record is None or record["kind"] != "claim":
            if time.monotonic() > end or record is not None:
                raise AssertionError(f"brain (b): no claim after "
                                     f"{evaluations} evaluations: {record} "
                                     f"(window {master.goodput_ledger
                                     .window_summary(30.0)})")
            evaluations += 1
            record = controller.evaluate_once()
            if record is None:
                time.sleep(0.05)
        marks["decision"] = record["ts"]
        rounds = mgr.rdzv_round
        marks["world2"] = world_of(2, "after the claim")
        claim = {"decision": record, "offer": offer.to_dict(),
                 "evaluations": evaluations,
                 "offer_to_decision_ms": (marks["decision"]
                                          - offer.offered_at) * 1e3,
                 "decision_to_world2_s": marks["world2"]
                 - marks["decision"],
                 "rounds": mgr.rdzv_round - rounds}
        log(f"brain (b) claim: {json.dumps(claim)} ({smi})")
        if (not record or record["kind"] != "claim"
                or record["evidence"]["granted"] != [1]
                or claim["rounds"] != 1):
            raise AssertionError(f"brain (b): {claim}")

        # -- (c) the revoke → rank 1 drains → a world of 1 ---------------
        end = time.monotonic() + 300
        while True:
            runs = rank1_runs()
            steps1 = runs[0]["steps"] if runs else {}
            if len(steps1) >= BRAIN_REVOKE_AT - 1:
                break
            if time.monotonic() > end or proc.poll() is not None:
                raise AssertionError(f"brain: rank 1 reached step "
                                     f"{len(steps1)} (agent exit "
                                     f"{proc.poll()})")
            time.sleep(0.05)
        # the master's copy of the revoke, at rank 0's next step
        step0 = len(fed)
        master._arm_master_chaos(f"revoke:slice:1@{step0 + 1}")
        code = proc.wait(timeout=300)
        marks["rank1_exit"] = time.time()
        with open(f"{tmp}/agent1.err") as f:
            agent_tail = f.read()[-3000:]
        if code != 0:
            raise AssertionError(f"brain: rank 1's agent exited {code}: "
                                 f"{agent_tail}")
        client0.join_rendezvous(local_world_size=1)
        marks["world1"] = world_of(1, "after the drain")
        after = len(fed)
        end = time.monotonic() + 120
        while len(fed) < after + BRAIN_AFTER:
            if time.monotonic() > end or not worker.is_alive():
                raise AssertionError(f"brain: rank 0 stopped at "
                                     f"{len(fed)} ({result})")
            time.sleep(0.02)
        stop.set()
        worker.join(timeout=120)
        if "error" in result:
            raise result["error"]
        launches0 = read_counts()
        peak0 = torch.cuda.max_memory_allocated() if on_card else 0
        hist = result["metrics"]["history"]
        loop.close()
        del state, result

        runs = rank1_runs()
        if len(runs) != 1:
            raise AssertionError(f"brain: {len(runs)} rank-1 incarnations")
        r1 = runs[0]
        with open(log1) as f:
            accum1 = int(re.search(r"accum=(\d+)", f.read()).group(1))
        drained = r1["marks"].get("drained", (0.0, ""))[1]
        step1 = sorted(r1["steps"])
        notice = r1["marks"].get("notice", (0.0, ""))[0]
        first1 = r1["steps"][step1[0]][0]
        # rank 0's steps by world: the batch of step n was handed out at
        # fed[n - 1]; a step is shared while rank 1 trains
        t_last1 = r1["steps"][step1[-1]][0]
        shared = [r["step_time_s"] for r in hist
                  if first1 <= fed[r["step"] - 1] <= t_last1]
        alone = [r["step_time_s"] for r in hist[2:]
                 if not first1 - 1.0 <= fed[r["step"] - 1]
                 <= marks["rank1_exit"]]
        with open(log1) as f:
            peaks1 = [int(json.loads(line.split(" ", 2)[2])["bytes"])
                      for line in f
                      if line.split(" ", 2)[1:2] == ["worker_allocator_peak"]]
        revoke = {
            "rank1_steps": step1, "rank1_accum": accum1,
            # the grant's process start, import and build to its first
            # step
            "decision_to_rank1_first_step_s": first1 - marks["decision"],
            "rank1_times": r1.get("times"),
            "drained": drained, "revoke_notice_to_world1_s":
            marks["world1"] - notice if notice else None,
            "rank1_exit_to_world1_s": marks["world1"] - marks["rank1_exit"],
            "rank0_steps": len(hist),
            "rank0_steps_lost": sum(1 for a, b in zip(hist, hist[1:])
                                    if b["step"] != a["step"] + 1)
            + (hist[0]["step"] - 1),
            "rank0_step_alone_ms": statistics.median(alone) * 1e3,
            "rank0_step_shared_ms": (statistics.median(shared) * 1e3
                                     if shared else None),
            "rank1_step_ms": statistics.median(
                r1["steps"][n][3] for n in step1[1:]) * 1e3,
            "rank0_peak_gib": peak0 / 2 ** 30 if on_card else None,
            "rank1_peak_gib": max(peaks1) / 2 ** 30 if peaks1 else None}
        log(f"brain (c) revoke: {json.dumps(revoke)} ({smi})")
        if (not drained.startswith("drained at step")
                or step1[0] != 1 or len(step1) < BRAIN_REVOKE_AT
                or revoke["rank0_steps_lost"] != 0
                or not all(math.isfinite(r["loss"]) for r in hist)
                or abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0
                or not shared):
            raise AssertionError(f"brain (c): {revoke}")
        status = client0.get_autoscale_status()
        claims = [d for d in status.get("decisions", [])
                  if d["kind"] == "claim"]
        reasons = [inc.get("reason") for inc in
                   master.goodput_ledger.snapshot()["incarnations"]]
        events = [e.get("name") for e in
                  obs.get_flight_recorder().snapshot()]
        snapshot = master._export_state()
        books = {"claims": [(d["id"], d["outcome"]) for d in claims],
                 "quarantine": status.get("quarantine"),
                 "incarnations": reasons,
                 "flight": {n: events.count(n) for n in (
                     "capacity_offer", "autoscale_decision",
                     "capacity_revoke")},
                 "snapshot_fleet_controller": sorted(
                     snapshot.get("fleet_controller", {}))}
        log(f"brain (c) books: {json.dumps(books)} ({smi})")
        if ([o for _, o in books["claims"]] != ["revoked"]
                or books["quarantine"] != {}
                or "autoscale" not in reasons or "drain" not in reasons
                or not all(books["flight"].values())
                or snapshot.get("fleet_controller")
                != controller.export_state()):
            raise AssertionError(f"brain (c): {books}")

        # -- (a) the brain --------------------------------------------------
        node1 = master.metric_collector.stats.latest_node_sample(
            NodeType.WORKER, 1)
        master.metric_collector.report_runtime()
        records = BrainClient(brain_addr).get_job_metrics(BRAIN_JOB)
        counts = {}
        for r in records:
            counts[r["record_type"]] = counts.get(r["record_type"], 0) + 1
        runtime = next(r["payload"] for r in records
                       if r["record_type"] == "runtime")
        plan = master.resource_optimizer.generate_plan(
            "oom-recovery", {"memory_mb": 1.0})
        worker_plan = plan.node_group_resources.get("worker")
        card_peak_mb = max([peak0] + peaks1) / 2 ** 20
        stored = brain.store.query(job_name=BRAIN_JOB)
        brain_out = {
            "records": counts, "runtime": runtime,
            "rank1_resource_sample": node1 is not None,
            "allocator_peak_mb": card_peak_mb,
            "plan": {"count": worker_plan.count if worker_plan else None,
                     "memory_mb": worker_plan.node_resource.memory_mb
                     if worker_plan else None},
            "same_over_the_wire": [r["payload"] for r in records]
            == [r["payload"] for r in stored]}
        log(f"brain (a): {json.dumps(brain_out)} ({smi})")
        peak_mem = max(r["payload"].get("peak_memory_mb", 0.0)
                       for r in stored if r["record_type"] == "runtime")
        if (counts.get("job_meta") != 1 or counts.get("model", 0) < 1
                or counts.get("runtime", 0) < 1
                or runtime.get("global_step", 0) < len(hist)
                or (on_card and abs(runtime.get("hbm_peak_mb", 0.0)
                                    - card_peak_mb) > 0.01 * card_peak_mb)
                or not brain_out["same_over_the_wire"]
                or worker_plan is None or peak_mem <= 0
                or abs(worker_plan.node_resource.memory_mb
                       - 1.8 * peak_mem) > 1e-6 * peak_mem):
            raise AssertionError(f"brain (a): {brain_out}")

        # launches: rank 0's, in this process, and rank 1's, its log's
        want0 = _expected_launches(cfg, len(hist))
        want1 = _expected_launches(cfg, len(step1) * accum1)
        launches1 = r1.get("launches")
        if not on_card:       # the plain versions on the CPU: no launch
            want0 = want1 = dict.fromkeys(want0, 0)
        if launches0 != want0 or launches1 != want1:
            raise AssertionError(f"brain launches: rank 0 {launches0} "
                                 f"(want {want0}), rank 1 {launches1} "
                                 f"(want {want1})")
        out["launches"] = {k: launches0[k] + launches1[k] for k in want0}
        out["launches_by_rank"] = {"0": launches0, "1": launches1}
        out.update(claim=claim, revoke=revoke, books=books, brain=brain_out)

        # -- (d) the operator -----------------------------------------------
        out["operator"] = _brain_operator(repo, master.addr, smi)
        # the master's stop reports the job's exit into the brain
        client0.close()
        master.stop()
        exits = [r["payload"]["stage"] for r in BrainClient(
            brain_addr).get_job_metrics(BRAIN_JOB, "job_exit")]
        out["job_exit"] = exits
        if exits != [JobStage.RUNNING]:
            raise AssertionError(f"brain: job_exit records {exits}")
    finally:
        stop.set()
        if worker is not None:
            worker.join(timeout=120)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files:
            f.close()
        client0.close()
        master.stop()
        ctx.update(**saved)
        brain.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"brain on {smi}: phase {out['phase_s']:.1f} s, launches "
        f"{json.dumps(out['launches'])}")
    return out


# ---------------------------------------------------------------------------
# sp: sequence parallelism and the quantized gradient mean
# ---------------------------------------------------------------------------

SP_SEQ = 4096                 # Llama-1B's tokens a row, 2 × 2048
SP_RANKS = 2
SP_STEPS = 3
# (b) Llama-1B at full width cut to 2 of its 22 layers: its step is host
# staging (the gradient's all-reduce scales with the parameters, the
# shifts and all-to-alls with the layers), and what (b) checks (each
# step against one process, the launches) does not depend on the depth
SP_LAYERS = 2
# (d) tensor parallelism over the ranks (tensor 2: 6 of the 12 heads
# each) for the fused-qkv families at full width, the models phase's
# shapes, cut to 2 of their 12 layers (what (d) checks of them does not
# depend on the depth): GPT-2 small (seq 1024, micro 12, causal) and
# BERT-base (seq 512, micro 32, bidirectional, dense MLM targets)
SP_TENSOR_LAYERS = 2
# and, on the same ranks: the Mixtral-width MoE at MOE_PARITY_LAYERS over
# tensor 2 (each rank 16 of 32 query heads, 4 of 8 KV heads, 7168 of
# 14336 columns of every expert), trained as the moe phase's flash
# parity run; the pipelined Llama-1B at CKPT_LAYERS over pipe 1 × tensor
# 2 (8 of 16 heads a rank); the pipelined Mixtral-width MoE at
# MOE_PARITY_LAYERS over pipe 1 × expert 2 (4 of 8 experts a rank); the
# pipelined ones 2 microbatches of 2 rows a step
SP_TENSOR = (
    {"family": "gpt2", "seq": 1024, "micro": 12, "layers": SP_TENSOR_LAYERS},
    {"family": "bert", "seq": 512, "micro": 32, "layers": SP_TENSOR_LAYERS},
    {"family": "moe", "seq": MOE_SEQ, "micro": MOE_MICRO,
     "layers": MOE_PARITY_LAYERS, "mesh": {"tensor": 2}},
    {"family": "pipe_llama", "seq": 2048, "micro": 2, "microbatches": 2,
     "layers": CKPT_LAYERS, "mesh": {"tensor": 2}},
    {"family": "pipe_moe", "seq": MOE_SEQ, "micro": 2, "microbatches": 2,
     "layers": MOE_PARITY_LAYERS, "mesh": {"expert": 2}},
)
# (d)'s MoE case over tensor 2: one step's gradients held with routing
# pinned, the expert kernels' compared at every SP_GRAD_ROWS-th embed row
SP_GRAD_ROWS = 16
SP_IMPLS = ("ring", "ulysses")
SP_ATTN = dict(b=1, h=16, s=SP_SEQ, d=128)
# (b) each step's loss and grad norm against the one-process run: the
# parity phase's limits (bf16 attention outputs rounded at other points)
SP_LOSS_TOL = PARITY_LOSS_TOL
SP_GRAD_NORM_TOL = PARITY_GRAD_NORM_TOL
# (c) one Llama-1B block's gradient leaves: q, k, v, o, gate, up, down and
# the two norm scales (50.6M values)
SP_BLOCK_LEAVES = ((2048, 2048),) * 4 + ((2048, 5504), (2048, 5504),
                                         (5504, 2048), (2048,), (2048,))
SP_QUANT = (("gather", 8), ("gather", 4), ("scatter", 8), ("scatter", 4))
# (e) Llama-1B at full width cut to SP_LAYERS over a dcn axis of the two
# ranks (two slices in one program), seq 2048, micro 2 a rank, the mean
# over dcn quantized to int8 (gather mode at 2 members: one quantize and
# one dequantize a leaf a step), SP_STEPS steps from the seed-0 init
SP_DCN = dict(model="llama_1b", layers=SP_LAYERS, seq=2048,
              micro=2 * SP_RANKS, steps=SP_STEPS, bits=8)
SP_DCN_BUDGET_S = 15.0

SP_WORKER = r'''
import contextlib, faulthandler, functools, json, os, sys, time

import numpy as np
import torch
import torch.distributed as dist

# a crash in native code leaves its Python stack in the rank's stderr
faulthandler.enable()
rank, port, gate = int(sys.argv[1]), sys.argv[2], sys.argv[3]
spec = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=spec["ranks"])
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import norms, quantization
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel import ring_attention as ra
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.parallel.quant_collectives import quantized_pmean
from dlrover_tpu_torch.trainer.train_step import build_trainer
print(json.dumps({"part": "ready", "rank": rank}), flush=True)
while not os.path.exists(gate):
    time.sleep(0.05)
dev = spec["device"]
if dev == "cuda":
    torch.cuda.set_device(0)
MODULES = (fa, norms, quantization)
group = dist.group.WORLD
size = dist.get_world_size()
# the world's lanes for (a)'s and (c)'s host-staged collectives (the
# trainer gives its own groups theirs)
collectives.set_lanes(group, [dist.new_group(backend="gloo")
                              for _ in range(collectives.STAGE_LANES)])


def reset():
    for m in MODULES:
        m.reset_launch_counts()


def counts():
    out = {}
    for m in MODULES:
        out.update(m.launch_counts)
    return out


def emit(**record):
    print(json.dumps(dict(record, rank=rank, t=time.time())), flush=True)


def sync():
    if dev == "cuda":
        torch.cuda.synchronize()


def config(impl):
    cfg = getattr(LlamaConfig, spec["model"])(
        max_seq_len=spec["seq"], attn_impl=impl, norm_impl="fused",
        embed_impl="gather")
    if spec["layers"]:
        import dataclasses
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    return cfg


def attention_part():
    """(a) the kernels in the ring and in Ulysses against the one-process
    kernels on the whole sequence and the plain ring."""
    a = spec["attn"]
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(a["b"], a["s"], a["h"], a["d"], generator=g,
                               device=dev).bfloat16() for _ in range(4))
    local = a["s"] // size
    mine = slice(rank * local, (rank + 1) * local)

    def run(fn, causal, block_impl):
        ql, kl, vl = (t[:, mine].clone().requires_grad_() for t in (q, k, v))
        o = fn(ql, kl, vl, group, causal=causal, block_impl=block_impl)
        o.backward(do[:, mine])
        return [o.detach(), ql.grad, kl.grad, vl.grad]

    for causal in (True, False):
        qf, kf, vf = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        of = fa.FlashAttentionFn.apply(qf, kf, vf, causal, None)
        of.backward(do.transpose(1, 2).contiguous())
        whole = [t.transpose(1, 2)[:, mine].contiguous()
                 for t in (of.detach(), qf.grad, kf.grad, vf.grad)]
        for kind, fn in (("ring", ra.ring_attention),
                         ("ulysses", ra.ulysses_attention)):
            plain = run(fn, causal, "einsum")
            sync()
            reset()
            t0 = time.perf_counter()
            got = run(fn, causal, "flash")
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launched = counts()
            errors = {}
            for name, x, w1, w2 in zip(("o", "dq", "dk", "dv"), got, whole,
                                       plain):
                errors[name] = {"one_process": fa.bf16_error(x, w1),
                                "plain_ring": fa.bf16_error(x, w2)}
            emit(part="a", kind=kind, causal=causal, errors=errors,
                 launches=launched, ms=ms,
                 expected=ra.expected_launches(size, rank, causal, kind))


def adamw(params):
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.1)


def training_part(impl, batches):
    """(b) Llama-1B at the sequence axis's full length, ``impl``
    attention, a step a batch."""
    cfg = config(impl)
    mesh = create_mesh(MeshSpec(sequence=size), device=dev)
    trainer = build_trainer(functools.partial(Llama, cfg), adamw, mesh,
                            np.zeros((1, spec["seq"])), cross_entropy_loss,
                            micro_batch=1)
    state = trainer.init(0)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    reset()
    for tokens, targets in batches:
        collectives.reset_staging_seconds()
        t0 = time.perf_counter()
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        steps.append({"loss": loss, "grad_norm": norm,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "staging_s": dict(collectives.staging_seconds)})
    launched = counts()
    emit(part="b", impl=impl, steps=steps, launches=launched,
         peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                   if dev == "cuda" else 0.0))
    del state, trainer
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def tensor_part(fam):
    """(d) a family over the world's tensor (or expert) axis, a step a
    batch: GPT-2 small or BERT-base (head-major fused qkv: each rank
    whole q, k and v heads), the Mixtral-width MoE over tensor (first one
    step's gradients with routing pinned to the one-process run's), the
    pipelined Llama-1B over pipe 1 × tensor or the pipelined MoE over
    pipe 1 × expert; the flash launches' shapes recorded as they
    launch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    import chip_smoke

    cfg = chip_smoke.sp_tensor_family(fam)[0]
    mesh = create_mesh(MeshSpec(**fam.get("mesh", {"tensor": size})),
                       device=dev)
    trainer = chip_smoke.sp_tensor_trainer(fam, mesh)
    state = trainer.init(0)
    name = fam["family"]
    ref = (torch.load(os.path.join(os.path.dirname(gate), f"ref_{name}.pt"))
           if "moe" in name else None)
    masks, pinned = [], None
    if ref is not None and not name.startswith("pipe"):
        pinned = chip_smoke.sp_pinned_grads(state.model, ref, masks)
    seen = []
    launchers = {name: getattr(fa, name) for name in
                 ("_launch_fwd", "_launch_bwd_dq", "_launch_bwd_dkv")}

    def recording(name, launch):
        def run(q, *args):
            # (kernel, b, h, s, d, causal): causal is the next-to-last
            seen.append([name] + list(q.shape) + [bool(args[-2])])
            return launch(q, *args)
        return run

    for key, launch in launchers.items():
        setattr(fa, key, recording(key, launch))
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps, comms = [], {}
    reset()
    try:
        for i, (tokens, targets) in enumerate(
                chip_smoke.sp_tensor_batches(fam, spec["steps"])):
            collectives.reset_staging_seconds()
            comm = chip_smoke.collective_counter() if i == 0 else None
            # the pipelined MoE's first step routes as the one-process
            # run's did, or moves the share printed
            routing = (chip_smoke._pinned_routing(record=masks)
                       if i == 0 and ref is not None and pinned is None
                       else contextlib.nullcontext())
            t0 = time.perf_counter()
            with comm or contextlib.nullcontext(), routing:
                state, m = trainer.step(
                    state, *trainer.shard_batch(tokens, targets))
                loss, norm = m["loss"].item(), m["grad_norm"].item()
            steps.append({"loss": loss, "grad_norm": norm,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "staging_s": dict(collectives.staging_seconds)})
            if comm is not None:
                comms = comm.counts
    finally:
        for key, launch in launchers.items():
            setattr(fa, key, launch)
    launched = counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev == "cuda" else 0.0)
    extra = {}
    if ref is not None:
        extra["moved"] = chip_smoke.sp_moved_share(masks, ref["masks"])
        extra["pinned"] = pinned
    if "moe" in name and not name.startswith("pipe"):
        experts = state.model.layer_0.moe.ExpertMLP_0
        extra["experts"] = [list(experts.wi.to_local().shape),
                            list(experts.wo.to_local().shape)]
    if name.startswith(("gpt", "bert")):
        # no collective between the fused projection and the attention: a
        # block's q, k and v of a replicated activation, with none
        # counted, each sharded over heads as the attention's local_map
        # takes them
        block = next(m for m in state.model.modules()
                     if hasattr(m, "qkv_heads"))
        kernel = block.qkv.kernel
        x = torch.randn(1, fam["seq"], kernel.shape[0], device=dev,
                        dtype=cfg.dtype)
        with torch.no_grad(), implicit_replication():
            x = DTensor.from_local(x, kernel.device_mesh, [Replicate()],
                                   run_check=False)
            probe = chip_smoke.collective_counter()
            with probe:
                qkv = block.qkv_heads(x)
        extra["qkv"] = {
            "collectives": sum(probe.counts.values()),
            "placements": sorted({str(t.placements) for t in qkv}),
            "local_heads": sorted({t.to_local().shape[2] for t in qkv}),
            "sharded_over_heads": all(
                t.placements == (Shard(2),) for t in qkv)}
        del x, qkv
    emit(part="d", family=name, steps=steps, launches=launched,
         shapes=sorted({tuple(s) for s in seen}), launched_shapes=len(seen),
         peak_gib=peak, comms_first_step=comms, **extra)
    del state, trainer, masks
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def dcn_part():
    """(e) Llama-1B over a dcn axis of the ranks: the in-slice mean exact,
    the mean over dcn quantized (the quantize and dequantize kernels)."""
    import dataclasses
    e = spec["dcn"]
    cfg = getattr(LlamaConfig, e["model"])(
        max_seq_len=e["seq"], attn_impl="flash", norm_impl="fused",
        embed_impl="gather")
    if e["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=e["layers"])
    mesh = create_mesh(MeshSpec(dcn=size), device=dev)
    trainer = build_trainer(functools.partial(Llama, cfg), adamw, mesh,
                            np.zeros((e["micro"], e["seq"])),
                            cross_entropy_loss, micro_batch=e["micro"],
                            grad_reduce_bits=e["bits"])
    state = trainer.init(0)
    rng = np.random.default_rng(13)
    batches = [tuple(rng.integers(0, cfg.vocab_size, (e["micro"], e["seq"]))
                     for _ in range(2)) for _ in range(e["steps"])]
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    reset()
    for tokens, targets in batches:
        collectives.reset_staging_seconds()
        t0 = time.perf_counter()
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        steps.append({"loss": loss, "grad_norm": norm,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "staging_s": dict(collectives.staging_seconds)})
    from dlrover_tpu_torch.parallel.quant_collectives import MIN_QUANT_SIZE
    emit(part="e", steps=steps, launches=counts(),
         leaves=sum(1 for _ in state.model.parameters()),
         quantized=sum(1 for p in state.model.parameters()
                       if p.numel() >= MIN_QUANT_SIZE),
         params=sum(p.numel() for p in state.model.parameters()),
         peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                   if dev == "cuda" else 0.0))
    del state, trainer
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def leaves_of(member):
    g = torch.Generator(device=dev).manual_seed(1000 + member)
    return [torch.randn(*shape, generator=g, device=dev)
            for shape in spec["leaves"]]


def quant_part():
    """(c) the quantized mean of one Llama-1B block's gradient leaves,
    each rank's from its own seed: the kernels against the plain versions
    bit for bit, and within the reference's bound of the exact mean."""
    mine = leaves_of(rank)
    everyone = [leaves_of(r) for r in range(size)]
    exact = [sum(m[i] for m in everyone) / size for i in range(len(mine))]
    largest = [max(m[i].abs().max().item() for m in everyone)
               for i in range(len(mine))]
    host = [t.cpu() for t in mine]
    for mode, bits in spec["quant"]:
        sync()
        reset()
        t0 = time.perf_counter()
        got = quantized_pmean(mine, group, size, bits=bits, mode=mode)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        want = quantized_pmean(host, group, size, bits=bits, mode=mode)
        same = all(torch.equal(x.cpu(), w) for x, w in zip(got, want))
        qmax = 127 if bits == 8 else 7
        passes = 2 if mode == "scatter" else 1
        ratio = max((x - e).abs().max().item() / (passes * big / qmax)
                    for x, e, big in zip(got, exact, largest))
        emit(part="c", mode=mode, bits=bits, bitwise=same,
             worst_of_bound=ratio, launches=launched, ms=ms,
             values=sum(t.numel() for t in mine))


# (a) and (c) beside the parent's one-process runs; (b) and (d) once it
# has freed the card's memory and opened the second gate
if "a" in spec["parts"]:
    emit(part="begin", what="a")
    attention_part()
if "c" in spec["parts"]:
    emit(part="begin", what="c")
    quant_part()
if any(part in spec["parts"] for part in "bde"):
    emit(part="begin", what="wait")
    while not os.path.exists(gate + ".b"):
        time.sleep(0.05)
if "b" in spec["parts"]:
    emit(part="begin", what="b")
    rng = np.random.default_rng(11)
    vocab = config("ring").vocab_size
    batches = [tuple(rng.integers(0, vocab, (1, spec["seq"]))
                     for _ in range(2)) for _ in range(spec["steps"])]
    for impl in spec["impls"]:
        training_part(impl, batches)
if "d" in spec["parts"]:
    emit(part="begin", what="d")
    for fam in spec["tensor"]:
        tensor_part(fam)
if "e" in spec["parts"]:
    emit(part="begin", what="e")
    dcn_part()
emit(part="done")
'''


def sp_spec(device: str = "cuda", small: bool = False,
            parts: str = "abcde", cases: tuple = ()) -> dict:
    """What the ranks run: parts (a) to (e) at the card's full sizes
    ((b) at SP_LAYERS), or ``small`` (the CPU rehearsal,
    ``device="cpu"``, and the card tests) with the tiny Llama, GPT,
    BERT and Mixtral and small shapes; ``cases``, when given, keeps the
    (d) cases whose family starts with one of them."""
    spec = _sp_spec(device, small, parts)
    if cases:
        spec["tensor"] = [f for f in spec["tensor"]
                          if f["family"].startswith(tuple(cases))]
    return spec


def _sp_spec(device: str, small: bool, parts: str) -> dict:
    if device == "cuda" and not small:
        return {"device": device, "ranks": SP_RANKS, "attn": SP_ATTN,
                "seq": SP_SEQ, "model": "llama_1b", "layers": SP_LAYERS,
                "steps": SP_STEPS, "impls": list(SP_IMPLS), "parts": parts,
                "leaves": [list(s) for s in SP_BLOCK_LEAVES],
                "quant": [list(q) for q in SP_QUANT],
                "tensor": [dict(f) for f in SP_TENSOR],
                "dcn": dict(SP_DCN)}
    return {"device": device, "ranks": SP_RANKS,
            "attn": dict(b=1, h=4, s=384, d=64), "seq": 64, "model": "tiny",
            "layers": 0, "steps": SP_STEPS, "impls": list(SP_IMPLS),
            "parts": parts, "leaves": [[64, 64], [64, 96], [2048]],
            "quant": [list(q) for q in SP_QUANT],
            "tensor": [{"family": "gpt_tiny", "seq": 64, "micro": 4},
                       {"family": "bert_tiny", "seq": 64, "micro": 4},
                       {"family": "moe_tiny", "seq": 64, "micro": 4,
                        "mesh": {"tensor": 2}},
                       {"family": "pipe_llama_tiny", "seq": 64, "micro": 2,
                        "microbatches": 2, "mesh": {"tensor": 2}},
                       {"family": "pipe_moe_tiny", "seq": 64, "micro": 2,
                        "microbatches": 2, "mesh": {"expert": 2}}],
            "dcn": dict(model="tiny", layers=0, seq=64, micro=4,
                        steps=SP_STEPS, bits=8)}


def _sp_config(spec: dict, attn_impl: str):
    import dataclasses

    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = getattr(LlamaConfig, spec["model"])(
        max_seq_len=spec["seq"], attn_impl=attn_impl, norm_impl="fused",
        embed_impl="gather")
    return (dataclasses.replace(cfg, num_layers=spec["layers"])
            if spec["layers"] else cfg)


def sp_tensor_family(fam: dict) -> tuple:
    """(config, model factory or None for a pipelined case, loss) of
    (d)'s ``fam``, at full width with the flash attention (and the fused
    norm where the family has one) and ``fam["layers"]`` deep (the
    config's depth when absent), or at its tiny preset (the CPU
    rehearsal): GPT-2 small, BERT-base, the Mixtral-width MoE in train
    routing, or the pipelined Llama-1B and Mixtral-width MoE."""
    import dataclasses

    from dlrover_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import LlamaConfig, cross_entropy_loss
    from dlrover_tpu_torch.models.llama_moe import LlamaMoEConfig

    name = fam["family"]
    tiny = name.endswith("tiny")
    layers = fam.get("layers", 0)
    if name.startswith("gpt"):
        cfg = (GPTConfig.tiny(attn_impl="flash") if tiny
               else GPTConfig(attn_impl="flash"))
        return (dataclasses.replace(cfg, n_layer=layers) if layers else cfg,
                GPT, cross_entropy_loss)
    if name.startswith("bert"):
        cfg = (BertConfig.tiny(attn_impl="flash") if tiny
               else BertConfig.base(attn_impl="flash"))
        return (dataclasses.replace(cfg, num_layers=layers) if layers
                else cfg, Bert, mlm_loss)
    if "moe" in name:
        cfg = (LlamaMoEConfig.mixtral_tiny(attn_impl="flash",
                                           norm_impl="fused",
                                           embed_impl="gather")
               if tiny else mixtral_config(layers))
        return (cfg, None if name.startswith("pipe") else _llama_moe,
                cross_entropy_loss)
    cfg = (LlamaConfig.tiny(attn_impl="flash", norm_impl="fused",
                            embed_impl="gather") if tiny else ckpt_config())
    return (dataclasses.replace(cfg, num_layers=layers) if layers else cfg,
            None, cross_entropy_loss)


def sp_tensor_trainer(fam: dict, mesh, device=None):
    """(d)'s trainer of ``fam`` on ``mesh`` (None: this process alone on
    ``device``): build_trainer from the seed-0 init, or the pipelined
    trainer for a ``pipe_`` case; AdamW(3e-4, wd 0.1), Adafactor(3e-4)
    for the MoE family."""
    import numpy as np

    from dlrover_tpu_torch.trainer.pipeline_trainer import (
        build_pipeline_trainer,
    )
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg, model_cls, loss_fn = sp_tensor_family(fam)
    optimizer = _adafactor if "moe" in fam["family"] else _adamw
    if model_cls is None:
        return build_pipeline_trainer(
            cfg, optimizer, mesh, fam["microbatches"], fam["micro"],
            fam["seq"], loss_fn, device=device)
    return build_trainer(functools.partial(model_cls, cfg), optimizer,
                         mesh, np.zeros((fam["micro"], fam["seq"])),
                         loss_fn, micro_batch=fam["micro"], device=device)


def sp_tensor_batches(fam: dict, steps: int) -> list:
    """(tokens, targets) of each of (d)'s steps for ``fam``, the same in
    the ranks and in this process (and in the moe phase's flash parity
    run for the MoE case): the targets drawn apart, BERT's the tokens
    themselves (dense MLM targets, as the models phase scores them)."""
    import numpy as np

    cfg = sp_tensor_family(fam)[0]
    seeds = {"gpt": 13, "bert": 17, "moe": 19, "pipe_llama": 23,
             "pipe_moe": 29}
    name = fam["family"].replace("_tiny", "").replace("gpt2", "gpt")
    rng = np.random.default_rng(seeds[name])
    shape = (fam["micro"] * fam.get("microbatches", 1), fam["seq"])
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab_size, shape)
        out.append((tokens, tokens if name == "bert"
                    else rng.integers(0, cfg.vocab_size, shape)))
    return out


def sp_tensor_launches(fam: dict, steps: int, ranks: int) -> tuple:
    """Each kernel's launches a rank over ``steps`` steps of (d)'s
    ``fam``, and the flash launches' shapes ([launcher, b, h, s, d,
    causal]: a microbatch's rows, the rank's heads, the head dim the
    kernels run at)."""
    cfg = sp_tensor_family(fam)[0]
    heads = getattr(cfg, "n_head", 0) or cfg.num_heads
    width = getattr(cfg, "n_embd", 0) or cfg.hidden_size
    tensor = fam.get("mesh", {"tensor": ranks}).get("tensor", 1)
    causal = not fam["family"].startswith("bert")
    shapes = [[kernel, fam["micro"], heads // tensor, fam["seq"],
               64 if width // heads <= 64 else 128, causal]
              for kernel in ("_launch_bwd_dkv", "_launch_bwd_dq",
                             "_launch_fwd")]
    if fam["family"].startswith("pipe"):
        return _pipeline_launches(cfg, steps * fam["microbatches"]), shapes
    return _expected_launches(cfg, steps), shapes


def collective_counter():
    """A dispatch mode counting the c10d collectives a region runs by op
    name (``.counts``), DTensor's own among them (a DTensor op is let run
    first and its collectives counted as it makes them, as CommDebugMode
    does), without CommDebugMode's module tracker, which loses its place
    when sibling projections take one input (the Llama attention's q, k
    and v) on torch 2.13."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            name = str(func._overloadpacket)
            # the functional ops' bookkeeping is not a collective
            if "c10d" in name and not name.endswith(
                    ("wait_tensor", "_wrap_tensor_autograd")):
                self.counts[name] = self.counts.get(name, 0) + 1
            return out

    return Counter()


def sp_moved_share(got: list, want: list) -> list:
    """The share of the kept (token, expert) assignments of ``want``'s
    routing that ``got``'s routing moved, mask by mask (a slot that moves
    within an expert's queue computes the same, a changed expert not)."""
    out = []
    for a, b in zip(got, want):
        kept = b.any(-1).cpu()
        out.append(((a.any(-1).cpu() != kept).sum() / kept.sum()).item())
    return out


def sp_reference_grads(grads: dict, layers: int) -> dict:
    """The leaves (d)'s MoE case holds with routing pinned, from one
    process's one-step gradients: name → (the gradient on the host, its
    embed rows sampled at every ``rows``-th, or 0 for whole): each
    layer's k_proj, router and wi."""
    out = {}
    for i in range(layers):
        prefix = f"layer_{i}."
        out[prefix + "attn.k_proj.kernel"] = (
            grads[prefix + "attn.k_proj.kernel"].float().cpu(), 0)
        out[prefix + "moe.router"] = (
            grads[prefix + "moe.router"].float().cpu(), 0)
        out[prefix + "moe.ExpertMLP_0.wi"] = (
            grads[prefix + "moe.ExpertMLP_0.wi"][:, ::SP_GRAD_ROWS]
            .float().cpu(), SP_GRAD_ROWS)
    return out


def sp_pinned_grads(model, ref: dict, masks: list) -> dict:
    """One step's gradients of ``model`` (a rank's, from the seed-0 init)
    on the one-process run's tokens with each layer's routing replayed
    from its masks; this rank's shard of each leaf in ``ref["grads"]``
    against the same part of the one-process gradient: name →
    {diff_sq, want_sq, sharded}. The routing this rank would take freely
    is appended to ``masks``; the gradients are cleared after."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.parallel.sharding import local_slice

    device = next(model.parameters()).device
    tokens, targets = (ref[k].to(device) for k in ("tokens", "targets"))
    with _pinned_routing(record=masks,
                         replay=[m.to(device) for m in ref["masks"]]), \
            implicit_replication():
        cross_entropy_loss(model(tokens), targets).backward()
    params = dict(model.named_parameters())
    out = {}
    for name, (want, rows) in ref["grads"].items():
        grad = params[name].grad
        sharded = isinstance(grad, DTensor)
        local = grad.to_local() if sharded else grad
        cut = (list(local_slice(grad.shape, grad.device_mesh,
                                grad.placements)) if sharded
               else [slice(None)] * grad.ndim)
        if rows:
            local, cut[1] = local[:, ::rows], slice(None)
        want = want[tuple(cut)].to(device)
        out[name] = {
            "diff_sq": ((local.float() - want) ** 2).sum().item(),
            "want_sq": (want ** 2).sum().item(),
            "sharded": sharded and any(p.is_shard()
                                       for p in grad.placements)}
    model.zero_grad(set_to_none=True)
    return out


def _sp_batches(spec: dict):
    """The rows both the ranks and the one-process run train on: the
    workers draw the same from the same seed."""
    import numpy as np

    rng = np.random.default_rng(11)
    vocab = _sp_config(spec, "flash").vocab_size
    return [tuple(rng.integers(0, vocab, (1, spec["seq"])) for _ in range(2))
            for _ in range(spec["steps"])]


SP_PROBE = r'''
import json, os, sys, time

import torch
import torch.distributed as dist

rank, port, gate, name = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
while not os.path.exists(gate):
    time.sleep(0.05)
x = torch.full((1024,), float(rank + 1), device="cuda")
if name == "all_reduce":
    dist.all_reduce(x)
    got, want = x, torch.full_like(x, 3.0)
elif name == "all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    got, want = torch.cat(parts), torch.cat([torch.full_like(x, v)
                                             for v in (1.0, 2.0)])
elif name == "all_to_all_single":
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x)
    want = torch.cat([torch.full((512,), v, device="cuda")
                      for v in (1.0, 2.0)])
elif name == "all_gather_into_tensor":
    got = torch.empty(2048, device="cuda")
    dist.all_gather_into_tensor(got, x)
    want = torch.cat([torch.full_like(x, v) for v in (1.0, 2.0)])
elif name == "reduce_scatter_tensor":
    got = torch.empty(512, device="cuda")
    dist.reduce_scatter_tensor(got, x)
    want = torch.full_like(got, 3.0)
else:
    got = torch.empty_like(x)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, 1 - rank),
            dist.P2POp(dist.irecv, got, 1 - rank)]):
        work.wait()
    want = torch.full_like(x, float(2 - rank))
torch.cuda.synchronize()
print(json.dumps({"right": bool(torch.equal(got, want))}), flush=True)
'''
# the gloo collectives probed with CUDA tensors: those the port stages,
# and the tensor forms DTensor's own redistributions call (a pending sum
# to a shard would be a reduce-scatter; the tensor axis's path reduces to
# a replica instead, parallel/sharding.reduce_partial)
SP_PROBES = ("all_reduce", "all_gather", "all_to_all_single", "isend_irecv",
             "all_gather_into_tensor", "reduce_scatter_tensor")


def _sp_probes(tmp: str, gate: str) -> dict:
    """Which gloo collectives take a CUDA tensor as it is on this torch
    (the port stages every one through host memory regardless): a pair
    of processes a collective, each pair alone, since gloo aborts its
    process on a device address it cannot read. Spawned at the phase's
    start, run at its gate; ``_sp_probe_results`` reads them."""
    import os
    import socket

    script = os.path.join(tmp, "sp_probe.py")
    with open(script, "w") as f:
        f.write(SP_PROBE)
    probes = {}
    for name in SP_PROBES:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        probes[name] = [subprocess.Popen(
            [sys.executable, script, str(rank), str(port), gate, name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(2)]
    return probes


def _sp_probe_results(probes: dict) -> dict:
    out = {}
    for name, pair in probes.items():
        verdicts = []
        for proc in pair:
            try:
                stdout, stderr = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                verdicts.append("no answer in 120 s")
                continue
            if proc.returncode == 0:
                right = json.loads(stdout.strip().splitlines()[-1])["right"]
                verdicts.append("takes CUDA tensors" if right
                                else "runs, wrong values")
            else:
                last = [line for line in stderr.splitlines()
                        if line.strip()][-1:]
                verdicts.append(f"exit {proc.returncode}: "
                                f"{last[0][:160] if last else ''}")
        out[name] = sorted(set(verdicts))
    return out


def _sp_workers(tmp: str, spec: dict) -> tuple:
    """The phase's rank processes, spawned when the script starts: each
    imports torch and the port, joins a gloo group of SP_RANKS on
    127.0.0.1 and waits for the gate file (no CUDA before it). Returns
    (processes, gate)."""
    import os
    import socket

    script = os.path.join(tmp, "sp_worker.py")
    with open(script, "w") as f:
        f.write(SP_WORKER)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    gate = os.path.join(tmp, "sp.go")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    procs = []
    for rank in range(SP_RANKS):
        # stderr to a file: a pipe nobody reads until the phase would fill
        with open(os.path.join(tmp, f"sp_rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(rank), str(port), gate,
                 json.dumps(spec)], stdout=subprocess.PIPE,
                stderr=err, text=True, env=env))
    return procs, gate


def _sp_reference(smi: str, spec: dict) -> list:
    """(loss, grad_norm) of each step of the ranks' model at their whole
    length trained by this process alone with the flash kernels on the
    same rows, from the same seed-0 init; freed before the ranks start."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = _sp_config(spec, "flash")
    trainer = build_trainer(functools.partial(Llama, cfg), _adamw, None,
                            torch.zeros((1, spec["seq"])),
                            cross_entropy_loss, micro_batch=1,
                            device=spec["device"])
    state = trainer.init(0)
    cuda = spec["device"] == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps = []
    for tokens, targets in _sp_batches(spec):
        t0 = time.perf_counter()
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        steps.append({"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "ms": (time.perf_counter() - t0) * 1e3})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    log(f"sp reference (one process, flash, seq {spec['seq']}): "
        f"{json.dumps(steps)}, peak {peak:.2f} GiB ({smi})")
    del state, trainer
    if cuda:
        _free_memory()
    return steps


def _sp_dcn_config(spec: dict):
    import dataclasses

    from dlrover_tpu_torch.models.llama import LlamaConfig

    e = spec["dcn"]
    cfg = getattr(LlamaConfig, e["model"])(
        max_seq_len=e["seq"], attn_impl="flash", norm_impl="fused",
        embed_impl="gather")
    return (dataclasses.replace(cfg, num_layers=e["layers"])
            if e["layers"] else cfg)


def _sp_dcn_reference(smi: str, spec: dict) -> list:
    """(e)'s reference: the ranks' rows (both micro batches, the global
    batch) trained exactly by this process alone, from the same seed-0
    init; (loss, grad_norm) a step."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    import numpy as np

    e = spec["dcn"]
    cfg = _sp_dcn_config(spec)
    trainer = build_trainer(functools.partial(Llama, cfg), _adamw, None,
                            torch.zeros((e["micro"], e["seq"])),
                            cross_entropy_loss, micro_batch=e["micro"],
                            device=spec["device"])
    state = trainer.init(0)
    rng = np.random.default_rng(13)
    steps = []
    for _ in range(e["steps"]):
        tokens, targets = (rng.integers(0, cfg.vocab_size,
                                        (e["micro"], e["seq"]))
                           for _ in range(2))
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        steps.append({"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item()})
    log(f"sp (e) reference (one process, {e['micro']} rows of "
        f"{e['seq']}, exact): {json.dumps(steps)} ({smi})")
    del state, trainer
    if spec["device"] == "cuda":
        _free_memory()
    return steps


def _sp_dcn(records: list, reference: list, smi: str, spec: dict,
            bad: list) -> dict:
    """(e): each rank's steps against the one-process exact run, and its
    launches as predicted: the flash and norm kernels of its micro batch
    a step, and one quantize and one dequantize a leaf a step (gather
    mode at two members; two of each in scatter mode), a leaf under
    MIN_QUANT_SIZE values taking the exact mean. Returns the runs'
    launches summed over the ranks."""
    e = spec["dcn"]
    cfg = _sp_dcn_config(spec)
    total = {}
    for rank_records in records:
        for rec in rank_records:
            if rec["part"] != "e":
                continue
            steps = rec["steps"]
            dl = [abs(s["loss"] - w["loss"]) for s, w in zip(steps,
                                                             reference)]
            dn = [abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                  for s, w in zip(steps, reference)]
            passes = 2 if spec["ranks"] > 4 else 1
            want = dict(_expected_launches(cfg, e["steps"]),
                        quantize=passes * rec["quantized"] * e["steps"],
                        dequantize=passes * rec["quantized"] * e["steps"])
            staging = [round(sum(s["staging_s"].values()), 3)
                       for s in steps]
            log(f"sp (e) dcn {spec['ranks']} int{e['bits']} rank "
                f"{rec['rank']}: {rec['params']} parameters in "
                f"{rec['leaves']} leaves ({rec['quantized']} quantized); "
                f"losses "
                f"{[s['loss'] for s in steps]} grad norms "
                f"{[s['grad_norm'] for s in steps]}; against one process: "
                f"max |loss diff| {max(dl):.3g} (limit {SP_LOSS_TOL}), max "
                f"grad-norm relative diff {max(dn):.3g} (limit "
                f"{SP_GRAD_NORM_TOL}); step ms "
                f"{[round(s['ms'], 1) for s in steps]}, host staging s a "
                f"step {staging}; launches {rec['launches']} (predicted "
                f"{want}); allocator peak {rec['peak_gib']:.2f} GiB ({smi})")
            if spec["device"] == "cuda" and rec["launches"] != want:
                bad.append(f"sp (e) rank {rec['rank']}: launches "
                           f"{rec['launches']}, predicted {want}")
            if len(steps) != e["steps"] or not (
                    max(dl) <= SP_LOSS_TOL and max(dn) <= SP_GRAD_NORM_TOL
                    and all(math.isfinite(s["loss"]) for s in steps)):
                bad.append(f"sp (e) rank {rec['rank']} disagrees with the "
                           f"one-process run")
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    if not total:
        bad.append("sp (e) ran on no rank")
    return total


# the one-process runs earlier phases made that (d) takes as its
# references (the moe phase's flash parity run: "moe"), by family
_SP_REFERENCES: dict = {}


def _moe_tp2_reference(fam: dict, device: str) -> dict:
    """(d)'s MoE reference when no moe phase ran in this process: one
    step's gradients from the seed-0 init on the parity tokens with the
    routing recorded, as ``_moe_parity`` takes them from its flash run."""
    from dlrover_tpu_torch.models.llama import cross_entropy_loss

    cfg = sp_tensor_family(fam)[0]
    tokens, targets = _moe_parity_tokens(cfg.vocab_size, fam["micro"],
                                         fam["seq"], device)
    masks = []
    model = _llama_moe(cfg, seed=0, device=device)
    with _pinned_routing(record=masks):
        cross_entropy_loss(model(tokens), targets).backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    out = {"tokens": tokens.cpu(), "targets": targets.cpu(),
           "masks": [m.cpu() for m in masks],
           "grads": sp_reference_grads(grads, cfg.num_layers)}
    del model, grads
    return out


def _sp_tensor_reference(smi: str, spec: dict, tmp: str) -> dict:
    """(d)'s references: each case's steps trained by this process alone
    (tensor and expert 1) on the ranks' rows from the same seed-0 init,
    the kernels on every head (the MoE case's taken from the moe phase's
    flash parity run when it ran here); for the MoE cases the routing
    (and for the MoE over tensor one step's gradients) written to
    ``tmp`` for the ranks. Freed before the ranks' second gate."""
    import os

    cuda = spec["device"] == "cuda"
    out = {}
    for fam in spec["tensor"]:
        name = fam["family"]
        cached = _SP_REFERENCES.get(name)
        if cached is not None:
            log(f"sp reference (d) {name}: the moe phase's flash parity run "
                f"{json.dumps(cached['steps'])}")
            out[name] = cached["steps"]
            torch.save({k: v for k, v in cached.items() if k != "steps"},
                       os.path.join(tmp, f"ref_{name}.pt"))
            continue
        ref = ({"masks": []} if name.startswith("pipe_moe")
               else _moe_tp2_reference(fam, spec["device"])
               if "moe" in name else None)
        trainer = sp_tensor_trainer(fam, None, spec["device"])
        state = trainer.init(0)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps = []
        for i, (tokens, targets) in enumerate(
                sp_tensor_batches(fam, spec["steps"])):
            routing = (_pinned_routing(record=ref["masks"])
                       if i == 0 and name.startswith("pipe_moe")
                       else contextlib.nullcontext())
            t0 = time.perf_counter()
            with routing:
                state, m = trainer.step(state,
                                        *trainer.shard_batch(tokens, targets))
            steps.append({"loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(),
                          "ms": (time.perf_counter() - t0) * 1e3})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        log(f"sp reference (d) {name} (one process): "
            f"{json.dumps(steps)}, peak {peak:.2f} GiB ({smi})")
        out[name] = steps
        if ref is not None:
            ref["masks"] = [m.cpu() for m in ref["masks"]]
            torch.save(ref, os.path.join(tmp, f"ref_{name}.pt"))
        del state, trainer, ref
        if cuda:
            _free_memory()
    return out


def _sp_records(procs: list, gate: str, timeout_s: float = SP_WAIT_S
                ) -> list:
    """Every JSON line of each rank, [rank][i]; a rank that fails fails
    the phase with its stderr."""
    import os

    deadline = time.monotonic() + timeout_s
    out = []
    for rank, proc in enumerate(procs):
        try:
            stdout, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"sp rank {rank} outlived {timeout_s} s")
        if proc.returncode:
            with open(os.path.join(os.path.dirname(gate),
                                   f"sp_rank{rank}.err")) as f:
                stderr = f.read()
            reached = [line[:300] for line in stdout.splitlines()
                       if line.startswith("{")][-3:]
            raise AssertionError(f"sp rank {rank} exited {proc.returncode} "
                                 f"after {reached}:\n{stderr[-6000:]}")
        out.append([json.loads(line) for line in stdout.splitlines()
                    if line.startswith("{")])
    return out


def _sp_part_seconds(records: list) -> dict:
    """Each part's seconds on the slower rank, from its ``begin`` mark to
    the next (``wait``: the ranks' wait for the one-process runs)."""
    out = {}
    for rank_records in records:
        marks = [(r["what"] if r["part"] == "begin" else "end", r["t"])
                 for r in rank_records if r["part"] in ("begin", "done")]
        for (what, t), (_, nxt) in zip(marks, marks[1:]):
            out[what] = max(out.get(what, 0.0), round(nxt - t, 1))
    return out


def _sp_attention(records: list, smi: str, cuda: bool) -> list:
    """(a): each rank's outputs and gradients within the flash tolerance
    of the one-process kernels' (element by element and the whole
    tensor's relative L2, the kernels phase's rule) and within its
    relative L2 limit of the plain ring's, which rounds at other points
    (f32 scores, probabilities and dS); the predicted launches (on the
    card). Returns what failed."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    bad = []
    for rank_records in records:
        for rec in rank_records:
            if rec["part"] != "a":
                continue
            want = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                            rec["expected"]))
            got = {k: rec["launches"][k] for k in want}
            what = (f"{rec['kind']} {'causal' if rec['causal'] else 'full'} "
                    f"rank {rec['rank']}")
            log(f"sp (a) {what}: launches {got} (predicted {want}), "
                f"{rec['ms']:.1f} ms forward + backward; errors "
                + json.dumps({n: {ref: {k: round(v, 5) for k, v in e.items()}
                                  for ref, e in refs.items()}
                              for n, refs in rec["errors"].items()})
                + f" ({smi})")
            if cuda and got != want:
                bad.append(f"{what}: launches {got}, predicted {want}")
            for name, refs in rec["errors"].items():
                for ref, err in refs.items():
                    if not (fa.bf16_within_tolerance(err)
                            if ref == "one_process"
                            else err["rel_l2"] <= fa.BF16_REL_L2):
                        bad.append(f"{what}: {name} against {ref} {err}")
    return [f"sp (a) {b}" for b in bad]


def _sp_training(records: list, reference: list, smi: str,
                 spec: dict, bad: list) -> dict:
    """(b): each rank's steps against the one-process run (what fails is
    added to ``bad``); returns the runs' launches summed over ranks and
    impls."""
    layers = _sp_config(spec, "flash").num_layers
    steps_n = spec["steps"]
    total = {}
    for impl in SP_IMPLS:
        runs = [rec for rank_records in records for rec in rank_records
                if rec["part"] == "b" and rec["impl"] == impl]
        for rec in runs:
            r = rec["rank"]
            steps = rec["steps"]
            dl = [abs(s["loss"] - w["loss"]) for s, w in zip(steps,
                                                             reference)]
            dn = [abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                  for s, w in zip(steps, reference)]
            staging = [round(sum(s["staging_s"].values()), 3)
                       for s in steps]
            log(f"sp (b) {impl} rank {r}: losses "
                f"{[s['loss'] for s in steps]} grad norms "
                f"{[s['grad_norm'] for s in steps]}; against one process: "
                f"max |loss diff| {max(dl):.3g} (limit {SP_LOSS_TOL}), max "
                f"grad-norm relative diff {max(dn):.3g} (limit "
                f"{SP_GRAD_NORM_TOL}); step ms "
                f"{[round(s['ms'], 1) for s in steps]}, host staging s a "
                f"step {staging} ({json.dumps(steps[-1]['staging_s'])}), "
                f"allocator peak {rec['peak_gib']:.2f} GiB ({smi})")
            blocks = r + 1 if impl == "ring" else 1
            want = {"flash_fwd": layers * blocks * steps_n,
                    "flash_bwd_dq": layers * blocks * steps_n,
                    "flash_bwd_dkv": layers * blocks * steps_n,
                    "rms_fwd": (2 * layers + 1) * steps_n,
                    "rms_bwd": (2 * layers + 1) * steps_n,
                    "quantize": 0, "dequantize": 0}
            if spec["device"] == "cuda" and rec["launches"] != want:
                bad.append(f"sp (b) {impl} rank {r}: launches "
                           f"{rec['launches']}, predicted {want}")
            if len(steps) != steps_n or not (
                    max(dl) <= SP_LOSS_TOL and max(dn) <= SP_GRAD_NORM_TOL
                    and all(math.isfinite(s["loss"]) for s in steps)):
                bad.append(f"sp (b) {impl} rank {r} disagrees with the "
                           f"one-process run")
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def _sp_dtensor_collectives(comms: dict) -> list:
    """The collectives DTensor ran itself in a step (its functional ops)
    beyond the grad norm's two scalar all-reduces: every other collective
    on the path is the port's own (host staged on the card's gloo)."""
    functional = {k: v for k, v in comms.items() if "functional" in k}
    return [f"{k}: {v}" for k, v in functional.items()
            if not k.endswith("all_reduce") or v > 2]


def _sp_pinned_errors(runs: list) -> dict:
    """Each leaf's relative L2 of the ranks' pinned-routing gradients
    against the one-process run's: a sharded leaf's squares summed over
    the ranks' shards, a replicated one's from rank 0."""
    out = {}
    for leaf in runs[0]["pinned"]:
        parts = [rec["pinned"][leaf] for rec in runs]
        if not parts[0]["sharded"]:
            parts = parts[:1]
        want = sum(p["want_sq"] for p in parts)
        out[leaf] = math.sqrt(sum(p["diff_sq"] for p in parts)
                              / max(want, 1e-30))
    return out


def _sp_tensor(records: list, reference: dict, smi: str, spec: dict,
               bad: list) -> dict:
    """(d): each rank's steps against the one-process run, the kernels'
    launches (the predicted count, every flash launch at the case's shape
    with the rank's heads, on the card), DTensor's own collectives (the
    grad norm's two scalar all-reduces at most), no collective between a
    fused projection and the attention, the MoE over tensor's gradients
    with routing pinned (what fails is added to ``bad``); returns the
    runs' launches summed over ranks and cases."""
    cuda = spec["device"] == "cuda"
    steps_n = spec["steps"]
    total = {}
    for fam in spec["tensor"]:
        name = fam["family"]
        want, want_shapes = sp_tensor_launches(fam, steps_n, spec["ranks"])
        runs = [rec for rank_records in records for rec in rank_records
                if rec["part"] == "d" and rec["family"] == name]
        if len(runs) != spec["ranks"]:
            bad.append(f"sp (d) {name}: {len(runs)} ranks reported")
        want_ref = reference[name]
        for rec in runs:
            r = rec["rank"]
            steps = rec["steps"]
            dl = [abs(s["loss"] - w["loss"]) for s, w in zip(steps,
                                                             want_ref)]
            dn = [abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                  for s, w in zip(steps, want_ref)]
            staging = [round(sum(s["staging_s"].values()), 3)
                       for s in steps]
            log(f"sp (d) {name} {json.dumps(fam.get('mesh', {}))} rank {r}: "
                f"losses {[s['loss'] for s in steps]} grad norms "
                f"{[s['grad_norm'] for s in steps]}; against one process: "
                f"max |loss diff| {max(dl):.3g} (limit {SP_LOSS_TOL}), max "
                f"grad-norm relative diff {max(dn):.3g} (limit "
                f"{SP_GRAD_NORM_TOL}); step ms "
                f"{[round(s['ms'], 1) for s in steps]}, host staging s a "
                f"step {staging} ({json.dumps(steps[-1]['staging_s'])}), "
                f"allocator peak {rec['peak_gib']:.2f} GiB; DTensor's own "
                f"collectives in step 1 {json.dumps(rec['comms_first_step'])}"
                f"; launches {json.dumps(rec['launches'])}, flash launches "
                f"at {rec['shapes']} ({rec['launched_shapes']} launches)"
                + "".join(f"; {k} {json.dumps(rec[k])}"
                          for k in ("qkv", "experts", "moved")
                          if k in rec) + f" ({smi})")
            if cuda and (rec["launches"] != want
                         or [list(s) for s in rec["shapes"]] != want_shapes):
                bad.append(f"sp (d) {name} rank {r}: launches "
                           f"{rec['launches']} at {rec['shapes']}, "
                           f"predicted {want} at {want_shapes}")
            extra = _sp_dtensor_collectives(rec["comms_first_step"])
            if extra:
                bad.append(f"sp (d) {name} rank {r}: DTensor's own "
                           f"collectives {extra}")
            if "experts" in rec:
                cfg = sp_tensor_family(fam)[0]
                t = fam["mesh"]["tensor"]
                e, h, m = (cfg.num_experts, cfg.hidden_size,
                           cfg.intermediate_size)
                if rec["experts"] != [[e, h, m // t], [e, m // t, h]]:
                    bad.append(f"sp (d) {name} rank {r}: expert kernels "
                               f"{rec['experts']}, not (E, H, M/{t}) and "
                               f"(E, M/{t}, H)")
            split = rec.get("qkv")
            if split is not None:
                cfg = sp_tensor_family(fam)[0]
                heads = getattr(cfg, "n_head", 0) or cfg.num_heads
                if (split["collectives"] != 0
                        or not split["sharded_over_heads"]
                        or split["local_heads"] != [heads // spec["ranks"]]):
                    bad.append(f"sp (d) {name} rank {r}: the qkv split "
                               f"{split}")
            if len(steps) != steps_n or not (
                    max(dl) <= SP_LOSS_TOL and max(dn) <= SP_GRAD_NORM_TOL
                    and all(math.isfinite(s["loss"]) for s in steps)):
                bad.append(f"sp (d) {name} rank {r} disagrees with the "
                           f"one-process run")
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        if runs and runs[0].get("pinned"):
            errors = _sp_pinned_errors(runs)
            worst = max(errors, key=errors.get)
            log(f"sp (d) {name}: one step's gradients with routing pinned "
                f"to the one-process run's, relative L2 (tolerance "
                f"{PARITY_GRAD_TOL}): "
                + ", ".join(f"{k} {v:.3g}" for k, v in errors.items()))
            if not errors[worst] <= PARITY_GRAD_TOL:
                bad.append(f"sp (d) {name}: gradients with routing pinned "
                           f"disagree: {worst} {errors[worst]}")
    return total


def _sp_quant(records: list, smi: str, spec: dict, bad: list) -> dict:
    """(c): bit for bit, within the bound, the predicted launches (on the
    card; what fails is added to ``bad``); returns the quantization
    pair's launches summed over ranks."""
    total = {"quantize": 0, "dequantize": 0}
    leaves = len(spec["leaves"])
    cuda = spec["device"] == "cuda"
    for rank_records in records:
        for rec in rank_records:
            if rec["part"] != "c":
                continue
            calls = leaves * (2 if rec["mode"] == "scatter" else 1)
            want = {"quantize": calls, "dequantize": calls}
            got = {k: rec["launches"][k] for k in want}
            log(f"sp (c) {rec['mode']} {rec['bits']}-bit rank "
                f"{rec['rank']}: {rec['values']} values, {rec['ms']:.1f} ms, "
                f"bit for bit with the plain versions: {rec['bitwise']}, "
                f"worst error {rec['worst_of_bound']:.3f} of the bound, "
                f"launches {got} (predicted {want}) ({smi})")
            if not (rec["bitwise"] and rec["worst_of_bound"] <= 1.0
                    and (got == want or not cuda)):
                bad.append(f"sp (c) failed: {rec}")
            for k in total:
                total[k] += got[k]
    return total


def phase_sp(smi: str, workers: tuple, spec: dict) -> dict:
    """Sequence parallelism and the quantized mean on the card, over two
    rank processes that share it in one gloo group (see the module
    docstring); ``workers`` from ``_sp_workers`` with ``spec``. The CPU
    rehearsal (``sp_spec("cpu")``, the tiny Llama) checks everything but
    the launches and the allocator."""
    import os

    procs, gate = workers
    probes = (_sp_probes(os.path.dirname(gate), gate)
              if spec["device"] == "cuda" else {})
    try:
        # the ranks run (a) and (c) beside the one-process run, (b) after
        # it has been freed
        t0 = time.monotonic()
        open(gate, "w").close()
        reference = (_sp_reference(smi, spec) if "b" in spec["parts"]
                     else [])
        tensor_reference = (_sp_tensor_reference(smi, spec,
                                                 os.path.dirname(gate))
                            if "d" in spec["parts"] else {})
        dcn_reference = (_sp_dcn_reference(smi, spec)
                         if "e" in spec["parts"] else [])
        open(gate + ".b", "w").close()
        t1 = time.monotonic()
        records = _sp_records(procs, gate)
        log(f"sp: the ranks ran {time.monotonic() - t0:.1f} s after the "
            f"first gate, {time.monotonic() - t1:.1f} s after the second")
        parts_s = _sp_part_seconds(records)
        log(f"sp: part seconds, the slower rank's {json.dumps(parts_s)}")
        if probes:
            log(f"sp: gloo collectives with CUDA tensors on torch "
                f"{torch.__version__}: "
                f"{json.dumps(_sp_probe_results(probes))}")
    finally:
        for proc in procs + [p for pair in probes.values() for p in pair]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (gate, gate + ".b"):
            if os.path.exists(path):
                os.remove(path)
    # every part is printed before a failure ends the phase
    bad = _sp_attention(records, smi, spec["device"] == "cuda")
    launches = (_sp_training(records, reference, smi, spec, bad)
                if "b" in spec["parts"] else {})
    if "d" in spec["parts"]:
        for k, v in _sp_tensor(records, tensor_reference, smi, spec,
                               bad).items():
            launches[k] = launches.get(k, 0) + v
    if "e" in spec["parts"]:
        for k, v in _sp_dcn(records, dcn_reference, smi, spec,
                            bad).items():
            launches[k] = launches.get(k, 0) + v
    for k, v in _sp_quant(records, smi, spec, bad).items():
        launches[k] = launches.get(k, 0) + v
    if bad:
        raise AssertionError(f"sp: {bad}")
    return {"launches": launches, "part_s": parts_s}


# ---------------------------------------------------------------------------
# slice: slice mode's host-level path under the port's control plane
# ---------------------------------------------------------------------------

# two slices of one agent each (``run --slice-id``), each training the
# nanoGPT example at --config nano on the card; the cross-slice mean is
# exact (dcn_sync_quant_bits 0), so two slices that each add the same two
# f32 values agree bit for bit. kill:slice:0 at SLICE_KILL_AT takes the
# whole of slice 0; it restores its last stage (a save every
# SLICE_SAVE_EVERY) from its agent's peer cache and catches up through
# the state handoff, and the survivor trains degraded meanwhile, each
# degraded step waiting SLICE_DCN_TIMEOUT_S for the silent slice
SLICE_STEPS = 40
SLICE_KILL_AT = 12
SLICE_SAVE_EVERY = 5
SLICE_DCN_TIMEOUT_S = 5.0
# the steps both slices must take in lockstep after the catch-up
SLICE_LOCKSTEP = 3
SLICE_BUDGET_S = 45.0
# beside the sp phase's ranks the phase took 86.4 s (PR 23's first call)
SLICE_WAIT_S = 180.0
SLICE_WORKER = ["dlrover_tpu_torch/examples/nanogpt_train.py", "--config",
                "nano"]


def slice_start(smi: str, device: str = "cuda") -> dict:
    """The slice phase's master (in this process) and its two agents,
    started; ``slice_finish`` waits for them and checks the run. The
    workers train on the card unless ``device`` is "cpu" (a rehearsal)."""
    import os
    import tempfile

    from dlrover_tpu_torch.master.job_master import JobMaster

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice_")
    master = JobMaster(min_nodes=1, max_nodes=2, host="127.0.0.1")
    master.prepare()
    run = {"master": master, "tmp": tmp, "procs": [], "files": [],
           "t0": time.monotonic(), "smi": smi}
    for sid in (0, 1):
        d = os.path.join(tmp, f"slice{sid}")
        os.makedirs(d)
        cmd = ([sys.executable, "-m", "dlrover_tpu_torch.run",
                "--master-addr", master.addr, "--node-rank", str(sid),
                "--slice-id", str(sid), "--monitor-interval", "1"]
               + SLICE_WORKER + (["--device", "cpu"] if device == "cpu"
                                 else [])
               + ["--steps", str(SLICE_STEPS), "--save-interval",
                  str(SLICE_SAVE_EVERY), "--report-interval", "1",
                  "--ckpt-dir", os.path.join(d, "ckpt"), "--log-file",
                  os.path.join(d, "log")])
        env = dict(os.environ, PYTHONPATH=repo, TMPDIR=d,
                   DLROVER_TPU_CHAOS=f"kill:slice:0@{SLICE_KILL_AT}",
                   DLROVER_TPU_CHAOS_STATE=os.path.join(tmp, "chaos"),
                   DLROVER_TPU_DCN_SYNC_TIMEOUT_S=str(SLICE_DCN_TIMEOUT_S),
                   DLROVER_TPU_DCN_SYNC_QUANT_BITS="0")
        fo = open(os.path.join(d, "agent.out"), "w")
        fe = open(os.path.join(d, "agent.err"), "w")
        run["files"] += [fo, fe]
        run["procs"].append(subprocess.Popen(cmd, cwd=repo, env=env,
                                             stdout=fo, stderr=fe))
    return run


def _slice_lines(path: str) -> list:
    """The worker's ``nanogpt:`` lines as dicts of their key=value
    fields."""
    import os

    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.startswith("nanogpt: "):
                    out.append(dict(field.split("=", 1) for field in
                                    line.split()[1:] if "=" in field))
    return out


def slice_finish(run: dict) -> dict:
    """Wait (bounded) for both agents and check the run: the survivor's
    worker never restarted and its slice's generation did not move; it
    took degraded steps, counted by the master's ledger and by
    ``dlrover_tpu_slice_degraded_steps_total{slice="1"}``; slice 0
    re-formed alone with its generation bumped, restored from its peer
    cache and caught up through the state handoff; both slices ended at
    the last step with the same parameters bit for bit, after at least
    SLICE_LOCKSTEP steps in lockstep."""
    import os
    import re
    import shutil

    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.common.constants import (
        DefaultValues,
        RendezvousName,
    )

    master, tmp, smi = run["master"], run["tmp"], run["smi"]
    bad = []
    try:
        deadline = run["t0"] + SLICE_WAIT_S
        codes = []
        for proc in run["procs"]:
            try:
                codes.append(proc.wait(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        seconds = time.monotonic() - run["t0"]
        mgr = master.rdzv_managers[RendezvousName.TRAINING]
        status = mgr.slice_status()
        ledger = master.goodput_ledger.snapshot()
        counter = re.findall(
            r'^dlrover_tpu_slice_degraded_steps_total\{slice="1"\} '
            r'([0-9.]+)$', obs.get_registry().render(), re.M)
        lines = [_slice_lines(os.path.join(tmp, f"slice{sid}", "log"))
                 for sid in (0, 1)]
        starts = [[ln for ln in ls if "start_step" in ln] for ls in lines]
        log(f"slice on {smi}: agents exited {codes} after {seconds:.1f} s "
            f"(budget {SLICE_BUDGET_S:.0f} s); slice status "
            f"{json.dumps(status)}; the ledger's degraded steps "
            f"{ledger.get('degraded_steps_total')}, the master's counter "
            f"for slice 1 {counter}; slice 0's worker {lines[0]}; slice "
            f"1's worker {lines[1]}")
        if codes != [0, 0]:
            for sid in (0, 1):
                with open(os.path.join(tmp, f"slice{sid}",
                                       "agent.err")) as f:
                    log(f"slice {sid} agent's log tail:\n"
                        f"{f.read()[-4000:]}")
            bad.append(f"agents exited {codes}")
        survivor_starts, victim_starts = starts[1], starts[0]
        if len(survivor_starts) != 1:
            bad.append(f"the survivor's worker started "
                       f"{len(survivor_starts)} times")
        slices = status.get("slices", {})
        if slices.get("1", {}).get("generation") != 1:
            bad.append(f"slice 1's generation moved: {slices.get('1')}")
        if slices.get("0", {}).get("generation", 0) < 2:
            bad.append(f"slice 0 did not re-form: {slices.get('0')}")
        degraded = int(ledger.get("degraded_steps_total", 0) or 0)
        if degraded < 1 or not counter or float(counter[0]) < 1:
            bad.append(f"no degraded step counted: ledger {degraded}, "
                       f"counter {counter}")
        if len(victim_starts) < 2:
            bad.append(f"slice 0's worker started {len(victim_starts)} "
                       f"times")
        else:
            again = victim_starts[-1]
            restored = int(again["start_step"])
            caught = int(again["catch_up"])
            log(f"slice: slice 0 restored step {restored} from "
                f"{again['source']}, caught up {caught} steps to "
                f"{restored + caught}; {SLICE_STEPS - restored - caught} "
                f"steps in lockstep after")
            if again["source"] != "peer" or caught < 1:
                bad.append(f"slice 0 did not peer-restore and catch up: "
                           f"{again}")
            if SLICE_STEPS - restored - caught < SLICE_LOCKSTEP:
                bad.append(f"fewer than {SLICE_LOCKSTEP} lockstep steps")
        ends = [[ln for ln in ls if "digest" in ln] for ls in lines]
        digests = [e[-1].get("digest") if e else None for e in ends]
        steps = [e[-1].get("step") if e else None for e in ends]
        if steps != [str(SLICE_STEPS)] * 2 or digests[0] != digests[1] \
                or digests[0] is None:
            bad.append(f"the slices ended at steps {steps} with "
                       f"parameters {digests}")
        else:
            log(f"slice: both slices at step {SLICE_STEPS} with the same "
                f"parameters bit for bit (sha256 {digests[0]})")
        from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

        params = sum(p.numel() for p in GPT(GPTConfig.nano(),
                                            device="meta").parameters())
        log(f"slice: the exact cross-slice payload is {4 * params} bytes "
            f"({params} f32 parameters) a slice a step, against C10's "
            f"{DefaultValues.GRPC_MAX_MESSAGE_MB} MB gRPC value limit "
            f"(about {DefaultValues.GRPC_MAX_MESSAGE_MB * 2 ** 20 // 4} "
            f"f32 parameters exact); {seconds:.1f} s of its "
            f"{SLICE_BUDGET_S:.0f} s budget ({smi})")
    finally:
        for proc in run["procs"]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in run["files"]:
            f.close()
        master.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        raise AssertionError(f"slice: {bad}")
    return {"phase_s": seconds, "degraded": degraded}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases",
                        default="kernels,quant,parity,llama1b,auto,"
                                "resume,standalone,faults,observe,failover,"
                                "replan,models,llama7b,moe,pipeline,"
                                "embedding,brain,sp,slice",
                        help="comma-separated subset of kernels, quant, "
                             "parity, llama1b, auto, resume, standalone, "
                             "faults, observe, failover, replan, models, "
                             "llama7b, moe, pipeline, embedding, brain, sp, "
                             "slice (device and build always run)")
    parser.add_argument("--profile", default="",
                        help="after the Llama-1B run, profile one more "
                             "step and write the kernel table here (and "
                             "after GPT-2's and BERT's runs, Llama-7B's "
                             "streaming and dense remat runs, the MoE "
                             "run and the pipelined Llama-1B runs, to this "
                             "path with .gpt2, .bert, .llama7b_streaming, "
                             ".llama7b_dense_remat, .moe, .pipeline and "
                             ".pipeline_bound added)")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    # a SIGTERM (a time limit) unwinds through the phases' ``finally``
    # blocks, which remove their directories (a peer cache on /dev/shm
    # among them)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    t0 = time.monotonic()
    smi = phase_device()
    sp_workers, sp_tmp = None, None
    if "sp" in phases:
        import tempfile

        # the sp phase's ranks import torch and the port beside the phases
        # before it, and wait at their gate
        sp_tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
        sp_workers = _sp_workers(sp_tmp, sp_spec())
    try:
        return _run_phases(args, phases, smi, sp_workers, t0)
    finally:
        if sp_workers is not None:
            import shutil

            for proc in sp_workers[0]:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(sp_tmp, ignore_errors=True)


def _run_phases(args, phases: list, smi: str, sp_workers, t0: float) -> int:
    # each phase's seconds, printed at the end
    seconds, mark = {}, [t0]

    def lap(name: str) -> None:
        now = time.monotonic()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now

    phase_build()
    lap("device+build")
    train_records = phase_kernels() if "kernels" in phases else []
    lap("kernels")
    quant_records = phase_quant() if "quant" in phases else []
    lap("quant")
    if "parity" in phases:
        phase_parity()
        lap("parity")
    llama1b = {}
    if "llama1b" in phases:
        # the training path's kernels take their launches from its run
        launches, llama1b = phase_llama1b(profile_out=args.profile)
        for rec in train_records:
            rec["launches"] = launches[rec["name"]]
        lap("llama1b")
    if "auto" in phases:
        # auto_accelerate's three runs: (a) the lowered strategy, (b) the
        # coworker-fed default strategy, (c) the search's dry runs and
        # its pick's steps, summed
        # (a) trains as long as the observe phase's reference, which it
        # then is
        auto = phase_auto(smi, llama1b, OBSERVE_STEPS
                          if "observe" in phases else AUTO_STEPS)
        for rec in train_records + quant_records:
            rec["auto_launches"] = auto["launches"][rec["name"]]
        lap("auto")
    resume = {}
    if "resume" in phases:
        # the quantization pair's path: the int8 checkpoint's save and
        # restore
        resume = phase_resume(smi)
        for rec in quant_records:
            rec["launches"] = resume["c"][f"{rec['name']}_launches"]
        lap("resume")
    if "standalone" in phases:
        # the worker under the agent counts its own launches, printed at
        # its exit: the resumed incarnation's steps
        standalone = phase_standalone(smi, resume)
        for rec in train_records + quant_records:
            rec["standalone_launches"] = standalone["launches"][rec["name"]]
        lap("standalone")
    if "faults" in phases:
        # the drained worker's, the hung one's up to its last finished
        # step, and its relaunch's, summed
        faults = phase_faults(smi, resume)
        for rec in train_records + quant_records:
            rec["faults_launches"] = sum(
                counts[rec["name"]]
                for counts in faults["launches"].values())
        lap("faults")
    if "observe" in phases:
        # the worker under the master that diagnoses it: its launches
        # over every step, the profiled ones among them
        observe = phase_observe(smi, llama1b)
        for rec in train_records + quant_records:
            rec["observe_launches"] = observe["launches"][rec["name"]]
        lap("observe")
    if "failover" in phases:
        # the worker that trained through its master's death
        failover = phase_failover(smi)
        for rec in train_records + quant_records:
            rec["failover_launches"] = failover["launches"][rec["name"]]
        lap("failover")
    if "replan" in phases:
        # the two replicas' incarnations, the leaver's and the
        # survivor's two, summed
        replan = phase_replan(smi)
        for rec in train_records + quant_records:
            rec["replan_launches"] = replan["launches"][rec["name"]]
        lap("replan")
    if "models" in phases:
        # GPT-2 small's and BERT-base's runs, summed
        models = phase_models(smi, args.profile)
        for rec in train_records + quant_records:
            rec["models_launches"] = models["launches"][rec["name"]]
        lap("models")
    if "llama7b" in phases:
        # the streaming and the dense remat run at full depth
        llama7b = phase_llama7b(smi, llama1b, args.profile)
        for rec in train_records + quant_records:
            rec["llama7b_launches"] = {
                kind: counts[rec["name"]]
                for kind, counts in llama7b["launches"].items()}
        lap("llama7b")
    if "moe" in phases:
        # the Mixtral-width run's 7 steps
        moe = phase_moe(smi, args.profile)
        for rec in train_records + quant_records:
            rec["moe_launches"] = moe["launches"][rec["name"]]
        lap("moe")
    if "pipeline" in phases:
        # the pipelined Llama-1B run's 7 steps of 4 microbatches
        pipeline = phase_pipeline(smi, llama1b, args.profile)
        for rec in train_records + quant_records:
            rec["pipeline_launches"] = pipeline["launches"][rec["name"]]
        lap("pipeline")
    if "embedding" in phases:
        # the embedding path runs none of the kernels: its counts, 0
        embedding = phase_embedding(smi)
        for rec in train_records + quant_records:
            rec["embedding_launches"] = embedding["launches"][rec["name"]]
        lap("embedding")
    if "brain" in phases:
        # both replicas' steps: rank 0's in this process and rank 1's
        # under its agent, summed
        brain = phase_brain(smi)
        for rec in train_records + quant_records:
            rec["brain_launches"] = brain["launches"][rec["name"]]
        lap("brain")
    sp_part_s = {}
    # the slice phase's agents run beside the sp phase's ranks: their
    # processes are the nano model's and the master's host-level sync,
    # and neither phase gates on the other's times
    slice_run = slice_start(smi) if "slice" in phases else None
    try:
        if "sp" in phases:
            # both ranks' (b) training runs (ring, Ulysses), their (d)
            # runs, their (e) runs over dcn 2 and their (c) quantized
            # means, summed
            sp = phase_sp(smi, sp_workers, sp_spec())
            sp_part_s = sp["part_s"]
            for rec in train_records + quant_records:
                rec["sp_launches"] = sp["launches"].get(rec["name"], 0)
            lap("sp")
    finally:
        slice_out = slice_finish(slice_run) if slice_run else {}
    if slice_run:
        lap("slice")
    records = train_records + quant_records
    elapsed = time.monotonic() - t0
    log(f"phase seconds: {json.dumps(seconds)}")
    log(f"elapsed {elapsed:.1f} s")
    log(f"budget: {elapsed:.1f} s of {SCRIPT_BUDGET_S:.0f} s (the "
        f"contract's limit is 1200 s); sp part (d) "
        f"{sp_part_s.get('d', 0.0):.1f} s of {SP_TENSOR_BUDGET_S:.0f} s, "
        f"part (e) {sp_part_s.get('e', 0.0):.1f} s of "
        f"{SP_DCN_BUDGET_S:.0f} s; the slice phase "
        f"{slice_out.get('phase_s', 0.0):.1f} s of {SLICE_BUDGET_S:.0f} s, "
        f"beside sp ({smi})")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
