from .pipeline import batch_iterator, pack_batch
from .workloads import MIXES, TASKS, WorkloadSample, make_sample, request_stream
