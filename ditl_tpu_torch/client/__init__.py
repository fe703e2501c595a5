from ditl_tpu_torch.client.llm import ERROR_SENTINEL, LLMClient, get_model_response  # noqa: F401
from ditl_tpu_torch.client.eval_loop import run_api_eval  # noqa: F401
