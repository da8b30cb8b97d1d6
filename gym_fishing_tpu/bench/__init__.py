from gym_fishing_tpu.bench.throughput import measure, measure_ppo_train
from gym_fishing_tpu.bench.profiling import time_fn, trace
from gym_fishing_tpu.bench.scaling import weak_scaling
