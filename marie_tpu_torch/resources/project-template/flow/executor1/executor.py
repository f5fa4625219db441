from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests
from marie_tpu_torch.types.docs import DocumentArray


class MyExecutor(BaseExecutor):
    @requests(on="/process")
    def process(self, docs: DocumentArray, **kwargs) -> DocumentArray:
        for doc in docs:
            doc.text = f"processed: {doc.text}"
        return docs
