# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: messenger.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fmessenger.proto\x12\x04grpc\x1a\x1bgoogle/protobuf/empty.proto\"\x1e\n\x0bLoadMessage\x12\x0f\n\x07program\x18\x01 \x01(\t\".\n\x0bSendMessage\x12\r\n\x05value\x18\x01 \x01(\x11\x12\x10\n\x08register\x18\x02 \x01(\x05\"\x1d\n\x0cValueMessage\x12\r\n\x05value\x18\x01 \x01(\x11\x32~\n\x06Master\x12\x38\n\x08GetInput\x12\x16.google.protobuf.Empty\x1a\x12.grpc.ValueMessage\"\x00\x12:\n\nSendOutput\x12\x12.grpc.ValueMessage\x1a\x16.google.protobuf.Empty\"\x00\x32\xa2\x02\n\x07Program\x12\x37\n\x03Run\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x39\n\x05Pause\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x39\n\x05Reset\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x33\n\x04Load\x12\x11.grpc.LoadMessage\x1a\x16.google.protobuf.Empty\"\x00\x12\x33\n\x04Send\x12\x11.grpc.SendMessage\x1a\x16.google.protobuf.Empty\"\x00\x32\xa1\x02\n\x05Stack\x12\x37\n\x03Run\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x39\n\x05Pause\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x39\n\x05Reset\x12\x16.google.protobuf.Empty\x1a\x16.google.protobuf.Empty\"\x00\x12\x34\n\x04Push\x12\x12.grpc.ValueMessage\x1a\x16.google.protobuf.Empty\"\x00\x12\x33\n\x03Pop\x12\x16.google.protobuf.Empty\x1a\x12.grpc.ValueMessage\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'messenger_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LOADMESSAGE._serialized_start=54
  _LOADMESSAGE._serialized_end=84
  _SENDMESSAGE._serialized_start=86
  _SENDMESSAGE._serialized_end=132
  _VALUEMESSAGE._serialized_start=134
  _VALUEMESSAGE._serialized_end=163
  _MASTER._serialized_start=165
  _MASTER._serialized_end=291
  _PROGRAM._serialized_start=294
  _PROGRAM._serialized_end=584
  _STACK._serialized_start=587
  _STACK._serialized_end=876
# @@protoc_insertion_point(module_scope)
