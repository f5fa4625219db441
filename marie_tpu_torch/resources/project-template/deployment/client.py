from marie_tpu_torch.clients import Client
from marie_tpu_torch.types.docs import Document

if __name__ == "__main__":
    client = Client(port=54321)
    docs = client.post("/process", [Document(text="hello")])
    print(docs[0].text)
